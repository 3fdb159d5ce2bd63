"""Seeded weights in the public checkpoints' layouts, made on the device.

The key manifests come from the plain reference's modules built on the
meta device (diffusers / Hugging Face state-dict names and shapes), and
from the reference trainer's EdgeStyle layout for the trainable set: the
fusion blocks, and for each ControlLoRA its zero-conv heads and the
``<module>.lora_layer.{down,up}.weight`` adapters of every trunk linear.
The LCM-LoRA of the ``lcm`` preset takes ``<module>.lora.{down,up}.weight``
over every UNet linear.

Every group of leaves of one type is drawn in one ``torch.randn`` call
from a ``torch.Generator`` on the device, then scaled leaf by leaf in
place: a weight at std 1/sqrt(fan_in), a bias at the std of its layer's
weight, a norm's scale at 1 + 0.1 z and its shift at 0.1 z, an embedding
at 0.02. No head and no adapter is zero, so every branch moves the image.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.reference.clip import CLIPTextModel
from portbench.reference.edgestyle import trunk_linear_modules, unet_linear_modules
from portbench.reference.sd15 import AutoencoderKL, ControlNetModel, UNet2DConditionModel

Manifest = Dict[str, Tuple[Tuple[int, ...], torch.dtype]]


def _shapes(module: torch.nn.Module, dtype) -> Manifest:
    return {k: (tuple(v.shape), dtype) for k, v in module.state_dict().items()}


def skip_shapes(unet_cfg: Dict, latent: int) -> List[Tuple[int, int]]:
    """(channels, side) of the 12 ControlNet skips, in order, for a square
    latent of side ``latent``."""
    chs, layers = unet_cfg["block_out_channels"], unet_cfg["layers_per_block"]
    out, side = [(chs[0], latent)], latent
    for i, ch in enumerate(chs):
        out += [(ch, side)] * layers
        if i < len(chs) - 1:
            side //= 2
            out.append((ch, side))
    return out


def manifest(cfg: Dict, lcm_rank: int = 0) -> Dict[str, Manifest]:
    """{"unet", "controlnet", "vae", "clip", "trainable.*"[, "lcm_lora"]}
    -> {key: (shape, dtype)}: frozen weights in the served type, trainables
    fp32 (as the finetune writes them)."""
    served = getattr(torch, cfg["dtype"])
    unet_cfg, vae_cfg = cfg["unet"], cfg["vae"]
    with torch.device("meta"):
        unet = UNet2DConditionModel(unet_cfg)
        cn = ControlNetModel(unet_cfg, tuple(unet_cfg["cond_embedding_channels"]))
        vae = AutoencoderKL(tuple(vae_cfg["block_out_channels"]), vae_cfg["latent_channels"],
                            vae_cfg["layers_per_block"])
        clip = CLIPTextModel(cfg["clip"])
    out = {"unet": _shapes(unet, served), "controlnet": _shapes(cn, served),
           "vae": _shapes(vae, served), "clip": _shapes(clip, served)}
    f32 = torch.float32
    latent = cfg["sample_size"] // 2 ** (len(vae_cfg["block_out_channels"]) - 1)
    n = len(cfg["pattern"])
    fusion: Manifest = {}
    skips = skip_shapes(unet_cfg, latent)
    names = [f"multi_controlnet_down_blocks.{k}" for k in range(len(skips))]
    mid_side = skips[-1][1]
    for name, (c, side) in zip(names + ["multi_controlnet_mid_block"],
                               skips + [(unet_cfg["block_out_channels"][-1], mid_side)]):
        fusion[f"{name}.first_conv.weight"] = ((c * n // 2, 2, 1, 1), f32)
        fusion[f"{name}.first_conv.bias"] = ((c * n // 2,), f32)
        fusion[f"{name}.first_normalization.weight"] = ((c * n // 2, side, side), f32)
        fusion[f"{name}.first_normalization.bias"] = ((c * n // 2, side, side), f32)
        fusion[f"{name}.second_conv.weight"] = ((c, n // 2, 1, 1), f32)
        fusion[f"{name}.second_conv.bias"] = ((c,), f32)
        fusion[f"{name}.second_normalization.weight"] = ((c, side, side), f32)
        fusion[f"{name}.second_normalization.bias"] = ((c, side, side), f32)
        fusion[f"{name}.third_conv.weight"] = ((c, 1, 1, 1), f32)
        fusion[f"{name}.third_conv.bias"] = ((c,), f32)
    out["trainable.fusion"] = fusion
    rank = cfg["controllora_rank"]
    unet_sd = out["unet"]
    heads = {k: (s, f32) for k, (s, _) in out["controlnet"].items()
             if k.startswith(("controlnet_down_blocks.", "controlnet_mid_block."))}
    trunk = trunk_linear_modules(unet_cfg)
    for pid in sorted({p for p in cfg["pattern"] if p is not None}):
        own = dict(heads)
        for mod in trunk:
            o, i = unet_sd[mod + ".weight"][0]
            own[f"{mod}.lora_layer.down.weight"] = ((rank, i), f32)
            own[f"{mod}.lora_layer.up.weight"] = ((o, rank), f32)
        out[f"trainable.controlnet_{pid}"] = own
    if lcm_rank:
        lcm: Manifest = {}
        for mod in unet_linear_modules(unet_cfg):
            o, i = unet_sd[mod + ".weight"][0]
            lcm[f"{mod}.lora.down.weight"] = ((lcm_rank, i), f32)
            lcm[f"{mod}.lora.up.weight"] = ((o, lcm_rank), f32)
        out["lcm_lora"] = lcm
    return out


def _std(key: str, shape: Tuple[int, ...], group: Manifest) -> Tuple[float, float]:
    """(mean, std) of one leaf's draw."""
    mod, leaf = key.rsplit(".", 1)
    last = mod.rsplit(".", 1)[-1]
    if last in ("token_embedding", "position_embedding"):
        return 0.0, 0.02
    if "norm" in last:
        return (1.0, 0.1) if leaf == "weight" else (0.0, 0.1)
    if leaf == "bias":
        shape = group[mod + ".weight"][0]
    return 0.0, 1.0 / math.sqrt(math.prod(shape[1:]))


def make(cfg: Dict, seed: int, device, lcm_rank: int = 0) -> Dict:
    """The seeded weights: {"unet", "controlnet", "vae", "clip", "trainable":
    {"fusion", "controlnet_0", ...}[, "lcm_lora"]}, each a flat state dict
    of views into one buffer per type."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % 2 ** 63)
    groups = manifest(cfg, lcm_rank)
    by_type: Dict[torch.dtype, List[Tuple[str, str, Tuple[int, ...]]]] = {}
    for gname, group in groups.items():
        for key, (shape, dtype) in group.items():
            by_type.setdefault(dtype, []).append((gname, key, shape))
    out: Dict = {g: {} for g in groups}
    for dtype, leaves in by_type.items():
        total = sum(math.prod(s) for _, _, s in leaves)
        flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
        off = 0
        for gname, key, shape in leaves:
            n = math.prod(shape)
            leaf = flat[off:off + n].view(shape)
            off += n
            mean, std = _std(key, shape, groups[gname])
            leaf.mul_(std)
            if mean:
                leaf.add_(mean)
            out[gname][key] = leaf
    trainable = {g.split(".", 1)[1]: out.pop(g) for g in list(out) if g.startswith("trainable.")}
    out["trainable"] = trainable
    return out
