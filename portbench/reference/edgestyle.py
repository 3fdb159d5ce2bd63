"""Plain PyTorch reference of EdgeStyle's try-on generation.

What the benchmark holds the port's images against. It reads the weights
the benchmark made, in the public checkpoints' layouts (diffusers and
Hugging Face names, the reference trainer's EdgeStyle layout), and works
out everything the port derives from them again: each ControlLoRA trunk as
the UNet's trunk with ``kernel + up @ down`` merged into every trunk
linear, the LCM-LoRA merge, the samplers' coefficients (float64 on the
host). Each branch runs as its own ControlNet call (the port batches the
branches that share weights), the fusion blocks are grouped convolutions on
NCHW tensors (the port sums NHWC reshapes), and attention is the plain
softmax product. Call it with fp32 weights and with TF32 off
(:func:`fp32_exact`).

The pipeline (the EdgeStyle app's generation): CLIP text -> the control
images' embeddings (VAE encode, posterior mean x 0.18215, into the UNet's
``conv_in`` for the ControlLoRA branches; the openpose ControlNet's conv
stack for the others) -> per step: every branch's 12 down and 1 mid
residual, the 13 fusion blocks over the channel-interleaved branches, the
UNet with the fused residuals, classifier-free guidance -> the sampler's
update -> VAE decode -> [0, 1].
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.clip import CLIPTextModel
from portbench.reference.sd15 import AutoencoderKL, ControlNetModel, UNet2DConditionModel

VAE_SCALING = 0.18215
FUSION_EPS = 1e-5
TRUNK_PREFIXES = ("conv_in.", "time_embedding.", "down_blocks.", "mid_block.")


@contextlib.contextmanager
def fp32_exact():
    """fp32 matrix products and convolutions in full fp32 (TF32 off), as the
    reference's precision requires; the flags are restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor absmax scale; the
    gradient passes straight through the rounding."""
    x = t.detach()
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(torch.float8_e4m3fn).max
    q = (x / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - x) if t.requires_grad else q


class Fp8Products(torch.overrides.TorchFunctionMode):
    """The control of a bf16 configuration: the reference with both operands
    of every matrix product and convolution rounded to float8 e4m3 (per
    tensor), the step below bf16; everything else stays fp32. A backward
    pass sees the rounded forward values; its own products stay fp32."""

    PRODUCTS = {F.linear, F.conv2d, torch.matmul, torch.bmm, torch.Tensor.__matmul__}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in self.PRODUCTS:
            args = (_fp8(args[0]), _fp8(args[1])) + tuple(args[2:])
        return func(*args, **(kwargs or {}))


def trunk_linear_modules(unet_cfg: Optional[Dict] = None) -> List[str]:
    """The ControlLoRA targets: every nn.Linear of the UNet's trunk (time
    embedding, ResNet time projections, attention q/k/v/out, GEGLU in and
    out). SD1.5's proj_in/proj_out are 1x1 convolutions, not targets."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(unet_cfg)
    return [n for n, m in unet.named_modules()
            if isinstance(m, torch.nn.Linear) and (n + ".").startswith(TRUNK_PREFIXES)]


def unet_linear_modules(unet_cfg: Optional[Dict] = None) -> List[str]:
    """The LCM-LoRA targets: every nn.Linear of the whole UNet."""
    with torch.device("meta"):
        unet = UNet2DConditionModel(unet_cfg)
    return [n for n, m in unet.named_modules() if isinstance(m, torch.nn.Linear)]


def _merged(sd: Dict[str, torch.Tensor], lora: Dict[str, torch.Tensor], suffix: str,
            dtype, device) -> Dict[str, torch.Tensor]:
    """``sd`` in ``dtype`` with W <- W + up @ down for each adapter in
    ``lora`` (keys ``<module>.<suffix>.down.weight`` / ``.up.weight``)."""
    out = {k: v.to(device, dtype) for k, v in sd.items()}
    tag = f".{suffix}.down.weight"
    for key in lora:
        if not key.endswith(tag):
            continue
        mod = key[:-len(tag)]
        up = lora[f"{mod}.{suffix}.up.weight"].to(device, dtype)
        down = lora[key].to(device, dtype)
        out[mod + ".weight"] = out[mod + ".weight"] + up.reshape(up.shape[0], -1) @ down
    return out


class Models:
    """The reference's modules, built from the benchmark's state dicts.

    ``weights``: {"unet", "controlnet", "vae", "clip"} (public layouts),
    "trainable": {"fusion", "controlnet_0", "controlnet_1"} (the reference
    trainer's EdgeStyle layout) and, for the LCM preset, "lcm_lora" (keys
    ``<module>.lora.down.weight`` over the UNet's linears)."""

    def __init__(self, weights: Dict, cfg: Dict, device, dtype=torch.float32):
        self.cfg = cfg
        self.pattern = tuple(cfg["pattern"])
        self.device = device
        unet_cfg, vae_cfg, clip_cfg = cfg["unet"], cfg["vae"], cfg["clip"]

        def build(cls, sd, *args, strict=True):
            with torch.device("meta"):
                mod = cls(*args)
            missing, unexpected = mod.load_state_dict(sd, strict=False, assign=True)
            if unexpected or (strict and missing):
                raise KeyError(f"{cls.__name__}: missing {missing[:4]}, unexpected "
                               f"{unexpected[:4]}")
            return mod.eval()

        cast = {k: v.to(device, dtype) for k, v in weights["unet"].items()}
        lcm = weights.get("lcm_lora")
        self.unet = build(UNet2DConditionModel,
                          _merged(cast, lcm, "lora", dtype, device) if lcm else cast, unet_cfg)
        self.static = build(ControlNetModel, {k: v.to(device, dtype) for k, v in
                                              weights["controlnet"].items()},
                            unet_cfg, tuple(cfg["unet"]["cond_embedding_channels"]))
        self.vae = build(AutoencoderKL, {k: v.to(device, dtype) for k, v in
                                         weights["vae"].items()},
                         tuple(vae_cfg["block_out_channels"]), vae_cfg["latent_channels"],
                         vae_cfg["layers_per_block"])
        self.clip = build(CLIPTextModel, {k: v.to(device, dtype) for k, v in
                                          weights["clip"].items()}, clip_cfg)
        trunk = {k: v for k, v in cast.items() if k.startswith(TRUNK_PREFIXES)}
        tr = weights["trainable"]
        self.lora = {}
        for pid in sorted({p for p in self.pattern if p is not None}):
            own = tr[f"controlnet_{pid}"]
            sd = _merged(trunk, own, "lora_layer", dtype, device)
            sd.update({k: v.to(device, dtype) for k, v in own.items()
                       if k.startswith("controlnet_") and "lora_layer" not in k})
            # the cond embedding is unused: these branches take the VAE
            # latents through the UNet's conv_in
            self.lora[pid] = build(ControlNetModel, sd, unet_cfg,
                                   tuple(cfg["unet"]["cond_embedding_channels"]), strict=False)
        self.fusion = {k: v.to(device, dtype) for k, v in tr["fusion"].items()}

    # ----------------------------------------------------------------
    def fuse(self, name: str, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """One fusion block: interleave the N branches' channels (c * N + n),
        grouped 1x1 over pairs of nets, LayerNorm([C, H, W]), SiLU, grouped
        1x1 to C, LayerNorm, SiLU, per-channel 1x1."""
        n = len(tensors)
        b, c, h, w = tensors[0].shape
        x = torch.stack(tensors, dim=2).reshape(b, c * n, h, w)
        p = {k[len(name) + 1:]: v for k, v in self.fusion.items() if k.startswith(name + ".")}
        x = F.conv2d(x, p["first_conv.weight"], p["first_conv.bias"], groups=c * n // 2)
        x = F.silu(F.layer_norm(x, x.shape[1:], p["first_normalization.weight"],
                                p["first_normalization.bias"], FUSION_EPS))
        x = F.conv2d(x, p["second_conv.weight"], p["second_conv.bias"], groups=c)
        x = F.silu(F.layer_norm(x, x.shape[1:], p["second_normalization.weight"],
                                p["second_normalization.bias"], FUSION_EPS))
        return F.conv2d(x, p["third_conv.weight"], p["third_conv.bias"], groups=c)

    def embed(self, cond_images: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        out = []
        for pos, pid in enumerate(self.pattern):
            im = cond_images[pos]
            if pid is None:
                out.append(self.static.controlnet_cond_embedding(im))
            else:
                mean = self.vae.encode_moments(im).chunk(2, dim=1)[0]
                out.append(self.unet.conv_in(mean * VAE_SCALING))
        return out

    def denoise(self, sample, t: int, ctx, embs, guidance: Optional[float]):
        """The noise prediction at one step; with ``guidance`` the rows are
        doubled [uncond; cond] and combined."""
        rows = torch.cat([sample, sample]) if guidance is not None else sample
        tt = torch.full((rows.shape[0],), t, dtype=torch.long, device=rows.device)
        downs, mids = [], []
        for pos, pid in enumerate(self.pattern):
            net = self.static if pid is None else self.lora[pid]
            e = torch.cat([embs[pos], embs[pos]]) if guidance is not None else embs[pos]
            d, m = net(rows, tt, ctx, e, cond_is_embedding=True)
            downs.append(d)
            mids.append(m)
        fused = [self.fuse(f"multi_controlnet_down_blocks.{k}", [d[k] for d in downs])
                 for k in range(len(downs[0]))]
        mid = self.fuse("multi_controlnet_mid_block", mids)
        eps = self.unet(rows, tt, ctx, fused, mid)
        if guidance is None:
            return eps
        uncond, cond = eps.chunk(2)
        return uncond + guidance * (cond - uncond)


# ------------------------------------------------------------ samplers
def sd15_alphas_cumprod(num_train_timesteps: int = 1000) -> np.ndarray:
    """scaled_linear betas 0.00085 -> 0.012, float64."""
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, num_train_timesteps,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


class UniPC:
    """diffusers' UniPCMultistepScheduler for SD1.5: bh2, order 2,
    predict_x0, lower_order_final, linspace timesteps, final sigma 0."""

    def __init__(self, steps: int, order: int = 2):
        ac = sd15_alphas_cumprod()
        T = len(ac)
        self.timesteps = np.linspace(0, T - 1, steps + 1).round()[::-1][:-1].astype(np.int64)
        sig = np.sqrt((1 - ac[self.timesteps]) / ac[self.timesteps])
        sig = np.append(sig, 0.0)
        self.alpha = 1.0 / np.sqrt(sig ** 2 + 1.0)
        self.sigma = sig * self.alpha
        with np.errstate(divide="ignore"):
            self.lam = np.log(self.alpha) - np.log(self.sigma)
        self.order = order
        self.steps = steps
        self.outputs: List = [None] * order
        self.last_sample = None
        self.lower_order_nums = 0
        self.this_order = 1

    def _coeffs(self, order: int, rks: List[float], h: float):
        hh = -h
        with np.errstate(all="ignore"):
            h_phi_1 = np.expm1(hh)
            h_phi_k = h_phi_1 / hh - 1.0
            B_h = np.expm1(hh)
            R, b, fact = [], [], 1.0
            for i in range(1, order + 1):
                R.append([r ** (i - 1) for r in rks])
                b.append(h_phi_k * fact / B_h)
                fact *= i + 1
                h_phi_k = h_phi_k / hh - 1.0 / fact
        return np.array(R), np.array(b), h_phi_1, B_h

    def _update(self, s0: int, t: int, m0, x, order: int, hist, x0_t=None):
        """One bh update from index ``s0`` to ``t``; ``hist`` the older x0
        predictions with their indices; with ``x0_t`` the corrector."""
        h = self.lam[t] - self.lam[s0]
        rks = [(self.lam[si] - self.lam[s0]) / h for si, _ in hist[:order - 1]]
        d1s = [(mi - m0) / rk for (_, mi), rk in zip(hist[:order - 1], rks)]
        R, b, h_phi_1, B_h = self._coeffs(order, rks + [1.0], h)
        with np.errstate(all="ignore"):
            c_x = self.sigma[t] / self.sigma[s0]
        x_t = float(c_x) * x - float(self.alpha[t] * h_phi_1) * m0
        if x0_t is None:
            if not d1s:
                return x_t
            rhos = [0.5] if order == 2 else np.linalg.solve(R[:-1, :-1], b[:-1])
            res = sum(float(r) * d for r, d in zip(rhos, d1s))
        else:
            rhos = [0.5] if order == 1 else np.linalg.solve(R, b)
            res = sum(float(r) * d for r, d in zip(rhos[:-1], d1s))
            res = res + float(rhos[-1]) * (x0_t - m0)
        return x_t - float(self.alpha[t] * B_h) * res

    def step(self, i: int, eps, sample):
        x0 = (sample - float(self.sigma[i]) * eps) / float(self.alpha[i])
        if i > 0:
            hist = [(i - 2 - k, self.outputs[-(k + 2)]) for k in range(self.order - 1)]
            sample = self._update(i - 1, i, self.outputs[-1], self.last_sample,
                                  self.this_order, hist, x0_t=x0)
        self.outputs = self.outputs[1:] + [x0]
        order = min(self.order, self.steps - i, self.lower_order_nums + 1)
        self.this_order = order
        self.last_sample = sample
        hist = [(i - 1 - k, self.outputs[-(k + 2)]) for k in range(self.order - 1)]
        nxt = self._update(i, i + 1, x0, sample, order, hist)
        self.lower_order_nums = min(self.lower_order_nums + 1, self.order)
        return nxt


class LCM:
    """diffusers' LCMScheduler for SD1.5 (50-step distillation grid,
    timestep_scaling 10, sigma_data 0.5, epsilon prediction): consistency
    estimate, re-noised to the next grid point with the given noise."""

    def __init__(self, steps: int, orig: int = 50):
        ac = sd15_alphas_cumprod()
        origin = np.arange(1, orig + 1, dtype=np.int64) * (len(ac) // orig) - 1
        idx = np.floor(np.linspace(0, orig, steps, endpoint=False)).astype(np.int64)
        self.timesteps = origin[::-1][idx]
        self.ac = ac
        self.steps = steps

    def step(self, i: int, eps, sample, noise):
        t = int(self.timesteps[i])
        a, s = np.sqrt(self.ac[t]), np.sqrt(1.0 - self.ac[t])
        x0 = (sample - float(s) * eps) / float(a)
        st = t * 10.0
        c_skip = 0.25 / (st ** 2 + 0.25)
        c_out = st / np.sqrt(st ** 2 + 0.25)
        den = float(c_out) * x0 + float(c_skip) * sample
        if i == self.steps - 1:
            return den
        tp = int(self.timesteps[i + 1])
        return float(np.sqrt(self.ac[tp])) * den + float(np.sqrt(1.0 - self.ac[tp])) * noise


# ------------------------------------------------------------ pipeline
@torch.no_grad()
def generate(models: Models, ids, neg_ids, cond_images: Sequence[torch.Tensor], latents, *,
             steps: int, guidance: float, sampler: str, cfg: bool,
             lcm_noise: Optional[Sequence[torch.Tensor]] = None, final: Optional[list] = None
             ) -> torch.Tensor:
    """(B, 3, H, W) images in [0, 1] for the given rows; ``cfg`` False runs
    the conditional prediction alone (the LCM preset). ``final``, a list,
    receives the latents the VAE decodes."""
    ctx = models.clip(torch.cat([neg_ids, ids]) if cfg else ids)
    embs = models.embed(cond_images)
    sched = UniPC(steps) if sampler == "unipc" else LCM(steps)
    sample = latents
    for i, t in enumerate(sched.timesteps):
        eps = models.denoise(sample, int(t), ctx, embs, guidance if cfg else None)
        if sampler == "unipc":
            sample = sched.step(i, eps, sample)
        else:
            sample = sched.step(i, eps, sample, lcm_noise[i] if i < steps - 1 else None)
    if final is not None:
        final.append(sample)
    img = models.vae.decode(sample / VAE_SCALING)
    return torch.clamp(img / 2 + 0.5, 0.0, 1.0)
