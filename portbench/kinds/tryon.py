"""Try-on generation cells: the port's ``EdgeStylePipeline.__call__``,
closed loop, one caller, one batch of requests after another.

The traffic file gives the batch, the steps, the guidance, the preset
(``exact``: UniPC with CFG every step; ``lcm``: the LCM sampler with CFG
off and a seeded LCM-LoRA merged into the UNet), how many images the check
samples and how many requests the traced run profiles. Each request's
inputs are drawn on the device from its own generator, seeded from the run's
seed and the request's index, so the check can draw any request again:
prompt and negative ids, the six control images (the VAE branches' in [-1,
1], the openpose branches' in [0, 1]), the initial latents and, for LCM,
the re-noise of every step but the last.

The port gets the weights through its own converters
(``port_*_state_dict``, ``port_fusion_state_dict``,
``port_controllora_state_dict``, ``controllora_params``,
``apply_lcm_lora``), the assembly ``core/pretrained.py`` makes from files.

The check: a sample of the window's images against the plain fp32
reference's (the worst image's 8 x 8-pooled mean gap), and the
configuration's precision held (``guarantees``: no operation on a type
below bf16 in one more request, which the port's own int8 path fails).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

from portbench import weights as weight_maker
from portbench.roofline import counted_flops
from portbench.reference import edgestyle as ref

LEVELS = 255.0
POOL = 8  # the VAE's downscale: one latent cell's pixels
CHECKED = ("image_pool8_mae_levels",)


def low_precision(dtype: torch.dtype) -> bool:
    """A type below the configuration's bf16: one byte or less (int8,
    uint8, the float8 and sub-byte types), bool aside."""
    return dtype != torch.bool and dtype.itemsize <= 1


class PrecisionWatch(TorchDispatchMode):
    """Counts the operations that take or give a tensor of a type below
    bf16, by name."""

    def __init__(self):
        super().__init__()
        self.ops: Dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = [t for t in pytree.tree_leaves((args, kwargs, out)) if isinstance(t, torch.Tensor)]
        if any(low_precision(t.dtype) for t in seen):
            name = str(func.overloadpacket)
            self.ops[name] = self.ops.get(name, 0) + 1
        return out


def image_gaps(img: torch.Tensor, ref_img: torch.Tensor) -> Dict[str, float]:
    """Gaps between two (3, H, W) images in [0, 1], in 0-255 levels: per
    pixel (mean, 99.9th percentile) and after an 8 x 8 average pool (mean,
    largest), at the latent grid's resolution. The check compares the
    pooled mean (``CHECKED``): the bf16 VAE decode's own per-pixel rounding
    is most of the per-pixel gap and half of the pooled one."""
    d = (img - ref_img).abs().flatten() * LEVELS
    pooled = (torch.nn.functional.avg_pool2d((img - ref_img)[None], POOL).abs() * LEVELS)
    return {"image_mae_levels": d.mean().item(),
            "image_p999_levels": d.kthvalue(max(1, int(0.999 * d.numel()))).values.item(),
            "image_pool8_mae_levels": pooled.mean().item(),
            "image_pool8_max_levels": pooled.max().item()}


def _port_params(w: Dict, cfg: Dict, pipe, device) -> Dict:
    from edgestyle_tpu_torch.core.params import flatten
    from edgestyle_tpu_torch.core.porting import tree_from_flat
    from edgestyle_tpu_torch.core.pretrained import (
        port_controllora_state_dict,
        port_fusion_state_dict,
    )
    from edgestyle_tpu_torch.models.clip_text import port_clip_text_state_dict
    from edgestyle_tpu_torch.models.unet import (
        controllora_params,
        port_controlnet_state_dict,
        port_unet_state_dict,
    )
    from edgestyle_tpu_torch.models.vae import port_vae_state_dict

    dt = pipe.dtype

    def cast(tree):
        return tree_from_flat({".".join(k): v for k, v in flatten(tree).items()}, device, dt)

    unet = tree_from_flat(port_unet_state_dict(w["unet"]), device, dt)
    clip = tree_from_flat(port_clip_text_state_dict(w["clip"], cfg["clip"]["num_layers"]),
                          device, dt)
    vae = tree_from_flat(port_vae_state_dict(w["vae"]), device, dt)
    static = tree_from_flat(port_controlnet_state_dict(w["controlnet"]), device, dt)
    tr = w["trainable"]
    fusion = tree_from_flat(port_fusion_state_dict(tr["fusion"]), device)
    cond = {"controlnet_cond_embedding": static["controlnet_cond_embedding"]}
    controlnet = {"static": static, "fusion": cast(fusion)}
    for key in sorted({g.params_key for g in pipe.mcn.groups if g.kind == "lora"}):
        i = key.split("_")[1]
        lora, heads = port_controllora_state_dict(tr[f"controlnet_{i}"])
        controlnet[key] = controllora_params(unet, tree_from_flat(lora, device),
                                             {**cast(tree_from_flat(heads, device)), **cond})
    params = {"vae": vae, "clip": clip, "unet": unet, "controlnet": controlnet}
    if "lcm_lora" in w:
        from edgestyle_tpu_torch.core.params import unflatten
        from edgestyle_tpu_torch.training.distill import apply_lcm_lora

        adapters = {}
        for key, v in w["lcm_lora"].items():
            if key.endswith(".lora.down.weight"):
                mod = key[:-len(".lora.down.weight")]
                (path, _), = port_unet_state_dict({mod + ".weight": v}).items()
                adapters[tuple(path.split("."))] = {
                    "down": v, "up": w["lcm_lora"][mod + ".lora.up.weight"]}
        params["unet"] = apply_lcm_lora(unet, unflatten(adapters))
    return params


def pipeline_config(cfg: Dict, traffic: Dict):
    from edgestyle_tpu_torch.models.clip_text import CLIPTextConfig
    from edgestyle_tpu_torch.models.unet import UNetConfig
    from edgestyle_tpu_torch.models.vae import VAEConfig
    from edgestyle_tpu_torch.pipelines.tryon import PipelineConfig

    u, v, c = cfg["unet"], cfg["vae"], cfg["clip"]
    return PipelineConfig(
        unet=UNetConfig(in_channels=u["in_channels"], out_channels=u["out_channels"],
                        block_out_channels=tuple(u["block_out_channels"]),
                        layers_per_block=u["layers_per_block"],
                        cross_attention_dim=u["cross_attention_dim"], num_heads=u["num_heads"],
                        cond_embedding_channels=tuple(u["cond_embedding_channels"])),
        vae=VAEConfig(latent_channels=v["latent_channels"],
                      block_out_channels=tuple(v["block_out_channels"]),
                      layers_per_block=v["layers_per_block"], sample_size=cfg["sample_size"]),
        clip=CLIPTextConfig(**{k: c[k] for k in ("vocab_size", "hidden_size", "num_layers",
                                                 "num_heads", "max_positions",
                                                 "intermediate_size")}),
        pattern=tuple(cfg["pattern"]), dtype=cfg["dtype"],
        scheduler=traffic["sampler"])


class Cell:
    """One try-on cell: set-up, one request per unit, the check."""

    rate_metric = "images_per_s"

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device, quant: str = "none"):
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.quant = quant
        self.batch = traffic["batch"]
        self.outputs: Dict[int, torch.Tensor] = {}
        self.pipe = self.params = None
        self.weights: Optional[Dict] = None

    # ---------------------------------------------------------- inputs
    def request(self, idx: int) -> Dict:
        """Request ``idx``'s inputs, drawn on the device from its own
        generator (the same for every run of this seed)."""
        cfg, t, dev = self.cfg, self.traffic, self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed((self.seed * 1_000_003 + idx + 1) % (2 ** 63))
        b, s = self.batch, cfg["sample_size"]
        n_tok, vocab = cfg["clip"]["max_positions"], cfg["clip"]["vocab_size"]
        ids = torch.randint(1, vocab - 1, (b, n_tok), generator=gen, device=dev)
        neg = torch.randint(1, vocab - 1, (b, n_tok), generator=gen, device=dev)
        imgs = []
        for pid in cfg["pattern"]:
            im = torch.rand((b, 3, s, s), generator=gen, device=dev)
            imgs.append(im if pid is None else im * 2 - 1)
        lat_side = s // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        shape = (b, cfg["unet"]["in_channels"], lat_side, lat_side)
        latents = torch.randn(shape, generator=gen, device=dev)
        noise = ([torch.randn(shape, generator=gen, device=dev)
                  for _ in range(t["steps"] - 1)] if t["sampler"] == "lcm" else None)
        return {"ids": ids, "neg": neg, "imgs": imgs, "latents": latents, "noise": noise}

    # ---------------------------------------------------------- system
    def setup(self, weights: Optional[Dict] = None) -> None:
        """The weights (made from the seed, or ``weights``), the port's
        pipeline on them, one warm-up request."""
        from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline

        marks = [time.perf_counter()]

        def mark():
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            marks.append(time.perf_counter())

        self.weights = weights if weights is not None else weight_maker.make(
            self.cfg, self.seed, self.device, lcm_rank=self.traffic.get("lcm_lora_rank", 0))
        mark()
        self.pipe = EdgeStylePipeline(pipeline_config(self.cfg, self.traffic),
                                      device=self.device, quant=self.quant)
        self.params = _port_params(self.weights, self.cfg, self.pipe, self.device)
        mark()
        self.generate(self.request(-1))  # warm-up: this cell's own shapes
        mark()
        self.setup_parts = {name: b - a for name, a, b in
                            zip(("weights_s", "port_s", "warmup_s"), marks, marks[1:])}

    def generate(self, req: Dict) -> torch.Tensor:
        t = self.traffic
        kw = {}
        if not t["cfg"]:
            kw["cfg_interval"] = (0.0, 0.0)
        if req["noise"] is not None:
            kw["lcm_noise"] = req["noise"]
        return self.pipe(self.params, req["ids"], req["neg"], req["imgs"],
                         latents=req["latents"], num_inference_steps=t["steps"],
                         guidance_scale=t["guidance"], **kw)

    def run_unit(self, idx: int) -> int:
        """Request ``idx``, delivered to the host; returns the images."""
        out = self.generate(self.request(idx))
        self.outputs[idx] = out.to("cpu")
        return self.batch

    def guarantees(self, n_units: int) -> Dict[str, float]:
        """The configuration's precision, held: one more request of the
        window's shapes, after it, with every operation's operand types
        watched; the number of operations on a type below bf16 (int8 or
        float8 products, their quantisers), which must be 0."""
        watch = PrecisionWatch()
        with watch:
            self.generate(self.request(n_units))
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.notes = {"low_precision_ops": dict(sorted(watch.ops.items())[:8])}
        return {"low_precision_ops": float(sum(watch.ops.values()))}

    def free(self) -> None:
        self.pipe = self.params = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # ---------------------------------------------------------- check
    def sample(self, n_units: int) -> List[Tuple[int, int]]:
        """The (request, row) pairs the check compares, drawn from the seed
        over every image the window delivered, stratified over the batch's
        rows: the k images come one from each of k equal runs of rows
        (one from each half of the batch at k = 2), so a fault confined to
        some rows of every batch is always sampled."""
        k = min(self.traffic["check_images"], n_units * self.batch)
        rng = np.random.default_rng(self.seed % 2 ** 63)
        strata = np.array_split(np.arange(self.batch), min(k, self.batch))
        pairs: set = set()
        for j in range(k):
            rows = strata[j % len(strata)]
            while True:
                pair = (int(rng.integers(n_units)), int(rng.choice(rows)))
                if pair not in pairs:
                    break
            pairs.add(pair)
        return sorted(pairs)

    def reference_images(self, pairs: List[Tuple[int, int]], latents: Optional[Dict] = None,
                         fp8: bool = False) -> Dict[Tuple[int, int], torch.Tensor]:
        """The plain fp32 reference's images for the sampled rows, one
        request's rows at a time; ``latents`` receives the latents each
        image was decoded from. ``fp8``: the control, every product's
        operands rounded to float8 (``ref.Fp8Products``)."""
        t = self.traffic
        out = {}
        with ref.fp32_exact(), (ref.Fp8Products() if fp8 else contextlib.nullcontext()):
            models = ref.Models(self.weights, self.cfg, self.device)
            for r in sorted({r for r, _ in pairs}):
                rows = [j for rr, j in pairs if rr == r]
                req = self.request(r)
                sel = torch.tensor(rows, device=self.device)
                noise = None if req["noise"] is None else [n[sel] for n in req["noise"]]
                final: list = []
                img = ref.generate(models, req["ids"][sel], req["neg"][sel],
                                   [im[sel] for im in req["imgs"]], req["latents"][sel],
                                   steps=t["steps"], guidance=t["guidance"],
                                   sampler=t["sampler"], cfg=t["cfg"], lcm_noise=noise,
                                   final=final)
                for k, j in enumerate(rows):
                    out[(r, j)] = img[k].float().cpu()
                    if latents is not None:
                        latents[(r, j)] = final[-1][k:k + 1]
            del models
        return out

    def gaps(self, n_units: int) -> Dict[str, float]:
        """The checked number: the worst sampled image's pooled mean gap to
        the reference, in 0-255 levels."""
        return self.gaps_to(self.reference_images(self.sample(n_units)))

    def gaps_to(self, refs: Dict[Tuple[int, int], torch.Tensor],
                stats: bool = False) -> Dict[str, float]:
        """The worst sampled image's gaps to the reference, in 0-255 levels.
        With ``stats``, every statistic the control reads."""
        out: Dict[str, float] = {}
        for (r, j), im in refs.items():
            for k, v in image_gaps(self.outputs[r][j].float(), im).items():
                out[k] = max(out.get(k, 0.0), v)
        return out if stats else {k: out[k] for k in CHECKED}

    # ---------------------------------------------------------- flops
    def model_flops_per_item(self) -> float:
        """The plain reference's FLOPs for one image at this cell's shapes,
        counted on the meta device (matrix products and convolutions): the
        prompt and control-image encodings, one denoise step times the
        steps (every step has the same shapes), the VAE decode."""
        meta = torch.device("meta")
        cfg, t = self.cfg, self.traffic
        w = weight_maker.manifest(cfg, t.get("lcm_lora_rank", 0))
        tree = {g: {k: torch.empty(s, device=meta) for k, (s, _) in m.items()}
                for g, m in w.items()}
        tree["trainable"] = {g.split(".", 1)[1]: tree.pop(g) for g in list(tree)
                             if g.startswith("trainable.")}
        models = ref.Models(tree, cfg, meta)
        s, n_tok = cfg["sample_size"], cfg["clip"]["max_positions"]
        side = s // 2 ** (len(cfg["vae"]["block_out_channels"]) - 1)
        lat = torch.empty((1, cfg["unet"]["in_channels"], side, side), device=meta)
        ids = torch.zeros((2 if t["cfg"] else 1, n_tok), dtype=torch.long, device=meta)
        imgs = [torch.empty((1, 3, s, s), device=meta) for _ in cfg["pattern"]]
        ctx = models.clip(ids)
        embs = models.embed(imgs)
        counts = [counted_flops(models.clip, ids), counted_flops(models.embed, imgs),
                  counted_flops(models.denoise, lat, 999, ctx, embs,
                                t["guidance"] if t["cfg"] else None),
                  counted_flops(models.vae.decode, lat)]
        return float(counts[0] + counts[1] + t["steps"] * counts[2] + counts[3])
