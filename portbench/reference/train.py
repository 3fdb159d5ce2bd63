"""Plain PyTorch reference of the ControlLoRA finetune's optimizer steps.

The reference recipe's step (EdgeStyle's
train_text2image_pretrained_openpose.py): the VAE posterior sample of the
target and of the three VAE conditions, the per-sample clothes <-> clothes2
swap, noise at uniform timesteps, the six branches (each ControlLoRA trunk
the UNet's trunk with ``W + up @ down`` in every trunk linear and its own
heads), the fusion blocks, the UNet's noise prediction, the MSE weighted by
Min-SNR-gamma (arXiv:2303.09556), the mean over the micro-batches of the
accumulation, clipping to a global norm, and Prodigy (arXiv:2306.06101, the
prodigyopt algorithm with decoupled weight decay, bias correction and
safeguard warmup). fp32 throughout; the random draws are the benchmark's.
Rows go through forward and backward one at a time, so that the full
activations fit; the gradient is their mean.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
from torch.func import functional_call

from portbench.reference.edgestyle import VAE_SCALING, Models, sd15_alphas_cumprod

D0 = 1e-6


def clip_global_norm(grads: Dict[str, torch.Tensor], max_norm: float) -> Dict[str, torch.Tensor]:
    """Scale by max_norm / ||g|| when ||g|| is at least max_norm."""
    norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values())).item()
    if norm < max_norm:
        return dict(grads)
    return {k: g * (max_norm / norm) for k, g in grads.items()}


class Prodigy:
    """prodigyopt.Prodigy (d_coef 1, unbounded growth) on a dict of fp32
    tensors, in float64 scalars."""

    def __init__(self, params: Dict[str, torch.Tensor], lr=1.0, betas=(0.9, 0.999), eps=1e-8,
                 weight_decay=0.0):
        self.lr, (self.b1, self.b2), self.eps, self.wd = lr, betas, eps, weight_decay
        self.b3 = math.sqrt(self.b2)
        self.d = self.d_max = D0
        self.num = 0.0
        self.k = 0
        self.p0 = {k: v.clone() for k, v in params.items()}
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.s = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor]):
        b1, b2, b3, d = self.b1, self.b2, self.b3, self.d
        bc = math.sqrt(1 - b2 ** (self.k + 1)) / (1 - b1 ** (self.k + 1))
        dlr = d * self.lr * bc
        dot = sum((grads[k].double() * (self.p0[k] - params[k]).double()).sum().item()
                  for k in params)
        self.num = b3 * self.num + (d / D0) * dlr * dot
        denom = 0.0
        for k, g in grads.items():
            self.m[k] = b1 * self.m[k] + d * (1 - b1) * g
            self.v[k] = b2 * self.v[k] + d * d * (1 - b2) * g * g
            self.s[k] = b3 * self.s[k] + (d / D0) * d * g
            denom += self.s[k].double().abs().sum().item()
        d_hat = self.num / denom if denom > 0 else d
        self.d_max = max(self.d_max, d_hat)
        self.d = max(self.d_max, d)
        out = {}
        for k, p in params.items():
            upd = dlr * self.m[k] / (self.v[k].sqrt() + self.d * self.eps) + dlr * self.wd * p
            out[k] = p - upd
        self.k += 1
        return out


class Trainer:
    """The frozen models (``Models``, fp32) and the step's loss on the
    trainables ``tr``: {"controlnet_<i>": ControlLoRA heads and adapters,
    "fusion": the fusion blocks}, the reference trainer's layout, flattened
    to ``<group>/<key>``."""

    def __init__(self, models: Models, cfg: Dict):
        self.m = models
        self.cfg = cfg
        for mod in (models.unet, models.static, models.vae, models.clip, *models.lora.values()):
            mod.requires_grad_(False)
        self.ac = torch.tensor(sd15_alphas_cumprod(), dtype=torch.float64)
        unet = dict(models.unet.named_parameters())
        self.trunk = {k: v for k, v in unet.items() if k.startswith(
            ("conv_in.", "time_embedding.", "down_blocks.", "mid_block."))}

    def branch_params(self, tr: Dict[str, torch.Tensor], pid: int) -> Dict[str, torch.Tensor]:
        g = f"controlnet_{pid}/"
        own = {k[len(g):]: v for k, v in tr.items() if k.startswith(g)}
        out = dict(self.trunk)
        for k, v in own.items():
            if k.endswith(".lora_layer.down.weight"):
                mod = k[:-len(".lora_layer.down.weight")]
                out[mod + ".weight"] = out[mod + ".weight"] + own[
                    mod + ".lora_layer.up.weight"] @ v
            elif "lora_layer" not in k:
                out[k] = v
        return out

    def row_loss(self, tr: Dict[str, torch.Tensor], row: Dict[str, torch.Tensor]):
        """One sample's Min-SNR-weighted squared error (its mean over the
        latent)."""
        m, dev = self.m, self.m.device
        f = bool(row["flip"])
        clothes, clothes2 = (row["clothes2"], row["clothes"]) if f else (row["clothes"],
                                                                        row["clothes2"])
        pose, pose2 = ((row["clothes_openpose2"], row["clothes_openpose"]) if f
                       else (row["clothes_openpose"], row["clothes_openpose2"]))
        first = row["agnostic"] if self.cfg["trainer"]["use_agnostic"] else row["head"]
        with torch.no_grad():
            def sample(x, eps):
                mean, logvar = m.vae.encode_moments(x[None]).chunk(2, dim=1)
                logvar = logvar.clamp(-30.0, 20.0)
                return (mean + torch.exp(0.5 * logvar) * eps[None]) * VAE_SCALING

            latents = sample(row["original"], row["vae_eps"])
            ctx = m.clip(row["input_ids"][None])
            t = int(row["timesteps"])
            a, s = math.sqrt(self.ac[t]), math.sqrt(1 - self.ac[t])
            noise = row["noise"][None]
            noisy = a * latents + s * noise
            conds = {0: first, 2: clothes, 4: clothes2}
            embs = {p: m.unet.conv_in(sample(im, row["cond_eps"][j]))
                    for j, (p, im) in enumerate(conds.items())}
            for p, im in {1: row["original_openpose"], 3: pose, 5: pose2}.items():
                embs[p] = m.static.controlnet_cond_embedding(im[None])
            tt = torch.full((1,), t, dtype=torch.long, device=dev)
            static = {p: m.static(noisy, tt, ctx, embs[p], cond_is_embedding=True)
                      for p, pid in enumerate(m.pattern) if pid is None}
        downs, mids = [], []
        params = {pid: self.branch_params(tr, pid) for pid in sorted(m.lora)}
        for pos, pid in enumerate(m.pattern):
            if pid is None:
                d, mid = static[pos]
            else:
                d, mid = functional_call(m.lora[pid], params[pid],
                                         (noisy, tt, ctx, embs[pos]),
                                         {"cond_is_embedding": True})
            downs.append(d)
            mids.append(mid)
        m.fusion = {k[len("fusion/"):]: v for k, v in tr.items() if k.startswith("fusion/")}
        fused = [m.fuse(f"multi_controlnet_down_blocks.{k}", [d[k] for d in downs])
                 for k in range(len(downs[0]))]
        mid = m.fuse("multi_controlnet_mid_block", mids)
        pred = m.unet(noisy, tt, ctx, fused, mid)
        snr = self.ac[t] / (1 - self.ac[t])
        w = float(min(snr, self.cfg["trainer"]["snr_gamma"]) / snr)
        return w * (pred - noise).square().mean()

    def step_grads(self, tr: Dict[str, torch.Tensor], batch: List[Dict[str, torch.Tensor]]):
        """(mean loss, mean gradient) over the step's rows."""
        leaves = {k: v.detach().requires_grad_(True) for k, v in tr.items()}
        grads = {k: torch.zeros_like(v) for k, v in tr.items()}
        total = 0.0
        for row in batch:
            loss = self.row_loss(leaves, row) / len(batch)
            for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()),
                                                        allow_unused=True)):
                if g is not None:
                    grads[k] += g
            total = total + loss.detach()
        return total, grads


def run_steps(trainer: Trainer, tr: Dict[str, torch.Tensor], batches: List, cfg: Dict) -> Dict:
    """The first ``len(batches)`` optimizer steps from ``tr``: each step's
    loss, the first step's clipped gradient, the trainables after the last
    step."""
    t = cfg["trainer"]
    opt = Prodigy(tr, lr=t["learning_rate"], betas=tuple(t["betas"]), eps=t["eps"],
                  weight_decay=t["weight_decay"])
    losses, first = [], None
    for batch in batches:
        loss, g = trainer.step_grads(tr, batch)
        g = clip_global_norm(g, t["max_grad_norm"])
        if first is None:
            first = g
        tr = opt.step(tr, g)
        losses.append(float(loss))
    return {"losses": losses, "grad1": first, "params": tr}
