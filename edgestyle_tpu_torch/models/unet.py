"""SD1.5 UNet and the ControlNet family.

Counterpart of edgestyle_tpu/models/unet.py. One trunk serves both the
UNet and the ControlNet (``controlnet_mode``), with the JAX package's
param names, so a ControlLoRA branch is the UNet's trunk subtree (plus its
merged LoRA) and its own zero-conv heads: :func:`controllora_params`.
Methods take the param tree first, like Flax's ``apply``. The diffusers
state-dict mappers (:func:`port_unet_state_dict`,
:func:`port_controlnet_state_dict`) close the file.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core import spans
from edgestyle_tpu_torch.core.params import flatten, sub, unflatten
from edgestyle_tpu_torch.core.partitioning import kernel_split
from edgestyle_tpu_torch.core.porting import KeyMapper
from edgestyle_tpu_torch.models.layers import (
    conv,
    downsample,
    group_norm_block,
    resnet_block,
    timestep_embedding,
    timestep_mlp,
    transformer_2d,
    upsample,
)
from edgestyle_tpu_torch.ops import tp


@dataclasses.dataclass(frozen=True)
class UNetConfig:
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Tuple[int, ...] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    cross_attention_dim: int = 768
    num_heads: int = 8
    norm_eps: float = 1e-5
    cond_embedding_channels: Tuple[int, ...] = (16, 32, 96, 256)
    conditioning_channels: int = 3

    @property
    def time_embed_dim(self) -> int:
        return self.block_out_channels[0] * 4


def cond_embedding(p, cond, channels: Sequence[int], out_channels: int, dtype):
    """ControlNet conditioning embedding: conv stack with stride-2 between
    channel jumps, zero-initialised 3x3 output conv."""
    ch = channels
    x = F.silu(conv(sub(p, "conv_in"), cond, ch[0], 3, dtype))
    for i in range(len(ch) - 1):
        x = F.silu(conv(sub(p, f"blocks_{2 * i}"), x, ch[i], 3, dtype))
        x = F.silu(conv(sub(p, f"blocks_{2 * i + 1}"), x, ch[i + 1], 3, dtype, stride=2))
    return conv(sub(p, "conv_out"), x, out_channels, 3, dtype, init="zeros")


class SD15UNet:
    """The UNet; with ``controlnet_mode`` the same trunk is a ControlNet:
    no up path, zero-conv heads, and a conditioning embedding input.
    ``tome`` (ops/tome.py::ToMeConfig, opt-in) merges tokens in every
    transformer block whose level it applies to; None is the exact model."""

    def __init__(self, cfg: UNetConfig = UNetConfig(), controlnet_mode: bool = False,
                 dtype: torch.dtype = torch.float32, tome=None):
        self.cfg = cfg
        self.controlnet_mode = controlnet_mode
        self.dtype = dtype
        self.tome = tome

    def skip_channels(self):
        cfg = self.cfg
        chs = cfg.block_out_channels
        out = [chs[0]]
        for i, ch in enumerate(chs):
            out += [ch] * cfg.layers_per_block
            if i < len(chs) - 1:
                out.append(ch)
        return out

    def _time_embedding(self, p, timesteps, batch: int):
        if timesteps.ndim == 0:
            timesteps = timesteps.expand(batch)
        temb = timestep_embedding(timesteps, self.cfg.block_out_channels[0])
        return timestep_mlp(sub(p, "time_embedding"), temb.to(self.dtype),
                            self.cfg.time_embed_dim, self.dtype)

    def _down_block(self, p, i: int, x, temb, context, run_downsample: bool = True):
        """Down block i: its ResNet blocks (+ transformers), then its
        downsampler unless it is the last block or ``run_downsample`` is
        off (shallow_forward never reads the downsampled skip). Returns (x,
        the block's skips)."""
        cfg, dt = self.cfg, self.dtype
        ch = cfg.block_out_channels[i]
        last = i == len(cfg.block_out_channels) - 1
        blk = sub(p, f"down_blocks_{i}")
        skips = []
        for j in range(cfg.layers_per_block):
            x = resnet_block(sub(blk, f"resnets_{j}"), x, temb, ch, dt)
            if not last:
                x = transformer_2d(sub(blk, f"attentions_{j}"), x, context, cfg.num_heads, dt,
                                   tome=self.tome)
            skips.append(x)
        if not last and run_downsample:
            x = downsample(sub(blk, "downsamplers_0"), x, ch, dt)
            skips.append(x)
        return x, skips

    def _up_block(self, p, i: int, x, skips, temb, context):
        """Up block i on x and its 1 + layers_per_block skips (popped from
        the end)."""
        cfg, dt = self.cfg, self.dtype
        rev = tuple(reversed(cfg.block_out_channels))
        blk = sub(p, f"up_blocks_{i}")
        for j in range(cfg.layers_per_block + 1):
            x = torch.cat([x, skips.pop()], dim=1)
            x = resnet_block(sub(blk, f"resnets_{j}"), x, temb, rev[i], dt)
            if i > 0:
                x = transformer_2d(sub(blk, f"attentions_{j}"), x, context, cfg.num_heads, dt,
                                   tome=self.tome)
        if i < len(rev) - 1:
            x = upsample(sub(blk, "upsamplers_0"), x, rev[i], dt)
        return x

    def _head(self, p, x):
        x = group_norm_block(sub(p, "conv_norm_out"), x, 32, self.cfg.norm_eps, act=F.silu)
        return conv(sub(p, "conv_out"), x, self.cfg.out_channels, 3, self.dtype).float()

    def _trunk(self, p, sample, timesteps, context, cond_emb=None):
        cfg, dt = self.cfg, self.dtype
        chs = cfg.block_out_channels
        temb = self._time_embedding(p, timesteps, sample.shape[0])
        context = context.to(dt)
        x = conv(sub(p, "conv_in"), sample, chs[0], 3, dt)
        if cond_emb is not None:
            x = x + cond_emb
        skips = [x]
        for i in range(len(chs)):
            x, s = self._down_block(p, i, x, temb, context)
            skips += s
        mid = sub(p, "mid_block")
        x = resnet_block(sub(mid, "resnets_0"), x, temb, chs[-1], dt)
        x = transformer_2d(sub(mid, "attentions_0"), x, context, cfg.num_heads, dt,
                           tome=self.tome)
        x = resnet_block(sub(mid, "resnets_1"), x, temb, chs[-1], dt)
        return x, skips, temb

    def __call__(self, p, sample, timesteps, encoder_hidden_states,
                 down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None,
                 mid_block_additional_residual: Optional[torch.Tensor] = None,
                 return_deep: bool = False):
        """Noise prediction (B, out_channels, h, w) fp32. With
        ``return_deep`` also the input to the last up block, the deep feature
        that :meth:`shallow_forward` splices back on later steps."""
        if self.controlnet_mode:
            raise ValueError("use controlnet_forward for a ControlNet")
        with spans.span(spans.UNET):
            x, skips, temb = self._trunk(p, sample, timesteps, encoder_hidden_states)
            if down_block_additional_residuals is not None:
                skips = [s + r for s, r in zip(skips, down_block_additional_residuals)]
            if mid_block_additional_residual is not None:
                x = x + mid_block_additional_residual
            ctx = encoder_hidden_states.to(self.dtype)
            n_up = len(self.cfg.block_out_channels)
            deep = None
            for i in range(n_up):
                if i == n_up - 1:
                    deep = x
                x = self._up_block(p, i, x, skips, temb, ctx)
            out = self._head(p, x)
            return (out, deep) if return_deep else out

    def shallow_forward(self, p, sample, timesteps, encoder_hidden_states, deep_feature,
                        down_block_additional_residuals: Optional[Sequence[torch.Tensor]] = None):
        """The DeepCache-style re-evaluation (opt-in serving approximation):
        conv_in, down block 0 without its downsampler and the last up block
        on ``deep_feature`` (``__call__(..., return_deep=True)`` at an
        earlier step), then conv_norm_out / conv_out. Only the first 1 +
        layers_per_block residuals are read; the deeper ones are baked into
        ``deep_feature``. With ``deep_feature`` captured at the same
        (sample, t) it returns ``__call__``'s output bit for bit."""
        if self.controlnet_mode:
            raise ValueError("shallow_forward is a UNet path, not a ControlNet one")
        with spans.span(spans.UNET):
            dt = self.dtype
            temb = self._time_embedding(p, timesteps, sample.shape[0])
            ctx = encoder_hidden_states.to(dt)
            x = conv(sub(p, "conv_in"), sample, self.cfg.block_out_channels[0], 3, dt)
            _, s = self._down_block(p, 0, x, temb, ctx, run_downsample=False)
            skips = [x] + s
            if down_block_additional_residuals is not None:
                skips = [sk + r for sk, r in zip(skips, down_block_additional_residuals)]
            n_up = len(self.cfg.block_out_channels)
            x = self._up_block(p, n_up - 1, deep_feature.to(dt), skips, temb, ctx)
            return self._head(p, x)

    def embed_cond(self, p, cond):
        """Raw conditioning image (B, 3, H, W) -> (B, 320, H/8, W/8)."""
        return cond_embedding(sub(p, "controlnet_cond_embedding"), cond.to(self.dtype),
                              self.cfg.cond_embedding_channels,
                              self.cfg.block_out_channels[0], self.dtype)

    def controlnet_forward(self, p, sample, timesteps, encoder_hidden_states, cond_embedding,
                           conditioning_scale: float = 1.0, guess_mode: bool = False):
        """ControlNet branch on a precomputed 320-channel cond embedding.
        Returns (down residuals, mid residual)."""
        dt = self.dtype
        x, skips, _ = self._trunk(p, sample, timesteps, encoder_hidden_states,
                                  cond_emb=cond_embedding)
        chans = self.skip_channels()
        down = [conv(sub(p, f"controlnet_down_blocks_{k}"), s, chans[k], 1, dt, padding=0,
                     init="zeros") for k, s in enumerate(skips)]
        mid = conv(sub(p, "controlnet_mid_block"), x, self.cfg.block_out_channels[-1], 1, dt,
                   padding=0, init="zeros")
        if guess_mode:
            scales = torch.logspace(-1, 0, len(down) + 1).tolist()
            scales = [s * conditioning_scale for s in scales]
        else:
            scales = [conditioning_scale] * (len(down) + 1)
        down = [r * s for r, s in zip(down, scales[:-1])]
        return tuple(down), mid * scales[-1]


# ------------------------------------------------------------ ControlLoRA
LORA_LINEAR_LEAF_NAMES = ("to_q", "to_k", "to_v", "to_out", "proj_in", "proj_out",
                          "time_emb_proj", "linear_1", "linear_2", "fc1", "fc2")
TRUNK_KEYS = ("conv_in", "time_embedding", "mid_block")  # + down_blocks_* prefix


def is_lora_linear_path(path: Tuple[str, ...]) -> bool:
    """LoRA targets: linear kernels in attention/ff/time-emb of the trunk."""
    if not path or path[-1] != "kernel":
        return False
    top = path[0]
    if not (top.startswith("down_blocks_") or top == "mid_block" or top == "time_embedding"):
        return False
    return any(path[-2] == n or path[-2].startswith(n) for n in LORA_LINEAR_LEAF_NAMES)


def is_lora_conv_path(path: Tuple[str, ...]) -> bool:
    """Conv-LoRA targets (with a conv rank > 0): every conv kernel of the
    tied trunk."""
    if not path or path[-1] != "kernel":
        return False
    top = path[0]
    return top == "conv_in" or top.startswith("down_blocks_") or top == "mid_block"


def split_trunk_params(unet_params: Dict) -> Dict:
    """The subtree a ControlLoRA ties to."""
    return {k: v for k, v in unet_params.items()
            if k in TRUNK_KEYS or k.startswith("down_blocks_")}


def init_lora_params(gen: torch.Generator, trunk_params: Dict, rank: int,
                     conv_rank: int = 0) -> Dict:
    """{path: {'down', 'up'}} adapters, fp32, in the port's layout. Every 2-D
    trunk linear kernel (out, in) gets down (rank, in) ~ N(0, 1/rank)
    (diffusers LoRALinearLayer) and up (out, rank) = 0. With ``conv_rank`` >
    0 every trunk conv kernel (out, in, kh, kw) also gets down (rank, in,
    kh, kw), a full-kernel conv to ``rank`` channels, and up (out, rank),
    the 1x1 after it. As in the reference, the conv adapters take the
    *linear* rank; ``conv_rank`` only switches them on."""
    lora = {}
    for path, leaf in flatten(trunk_params).items():
        if is_lora_linear_path(path) and leaf.ndim == 2:
            dout, din = leaf.shape
            down_shape = (rank, din)
        elif conv_rank > 0 and leaf.ndim == 4 and is_lora_conv_path(path):
            dout, din, kh, kw = leaf.shape
            down_shape = (rank, din, kh, kw)
        else:
            continue
        lora[path] = {
            "down": torch.randn(down_shape, generator=gen, device=gen.device) / rank,
            "up": torch.zeros((dout, rank), device=gen.device),
        }
    return unflatten(lora)


def merge_lora(trunk_params: Dict, lora_params: Dict, scale: float = 1.0) -> Dict:
    """Trunk params with kernel <- kernel + scale * (up o down), as a new
    tree; untouched leaves are shared, not copied. Linear: up @ down; conv:
    einsum('or,rihw->oihw'), the composition of the k x k down conv and the
    1x1 up conv, kept channels_last (the fused conv kernel reads that
    layout).

    Inside ``ops.tp.model_parallel`` a linear kernel smaller than its
    adapter's (out, in) is this rank's slice of a tensor-parallel kernel:
    it takes the same slice of the full delta, by the rule it was sliced by
    (core/partitioning.py::kernel_split: GEGLU's proj_in per half), so the
    merged slice is the single process's merged kernel, sliced; the slice
    is taken of ``up``'s rows (column-parallel) or ``down``'s columns
    (row-parallel) before the product. Its adapter
    leaves pass through ``CopyToModel`` first: each rank's gradient of them
    is a partial sum over its slice, which the backward sums over the model
    group. Every other adapter, and every other trainable, already gets its
    whole gradient on each rank."""
    def walk(node, prefix=()):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict) and set(v) == {"down", "up"}:
                out[prefix + (k,)] = v
            elif isinstance(v, dict):
                out.update(walk(v, prefix + (k,)))
        return out

    merged = flatten(trunk_params)
    for path, lp in walk(lora_params).items():
        base = merged[path]
        if lp["down"].ndim == 4:
            delta = torch.einsum("or,rihw->oihw", lp["up"], lp["down"]) * scale
            merged[path] = (base + delta.to(base.dtype)).contiguous(
                memory_format=torch.channels_last)
        elif tuple(base.shape) != (lp["up"].shape[0], lp["down"].shape[1]):
            up, down = tp.copy_to_model(lp["up"]), tp.copy_to_model(lp["down"])
            split = kernel_split(path, (up.shape[0], down.shape[1]), tp.size())
            # the slice before the product: up's rows of a column-parallel
            # kernel, down's columns of a row-parallel one
            if split.dim == 0:
                up = split.take(up, tp.index(), tp.size())
            else:
                down = split.take(down, tp.index(), tp.size())
            merged[path] = base + ((up @ down) * scale).to(base.dtype)
        else:
            delta = (lp["up"] @ lp["down"]) * scale
            merged[path] = base + delta.to(base.dtype)
    return unflatten(merged)


def controllora_params(unet_params: Dict, lora_params: Dict, head_params: Dict,
                       lora_scale: float = 1.0) -> Dict:
    """A ControlLoRA branch's tree: tied trunk (+ merged LoRA) + its own
    zero-conv heads (``controlnet_down_blocks_*`` / ``controlnet_mid_block``)."""
    trunk = split_trunk_params(unet_params)
    merged = merge_lora(trunk, lora_params, lora_scale) if lora_params else dict(trunk)
    merged.update(head_params)
    return merged


# ------------------------------------------------- diffusers checkpoints
# diffusers UNet2DConditionModel / ControlNetModel state dicts (the
# SG161222/Realistic_Vision_V5.1_noVAE UNet, lllyasviel's openpose
# ControlNet) -> the port's flat {path: leaf}. Torch's layouts are the
# port's, so the rules only rename. The block indices stay regex groups,
# over the ranges the JAX package's mappers accept.
def _groups(pattern: str) -> int:
    return re.compile(pattern).groups


def _map_transformer(m: KeyMapper, tp: str, fp: str) -> KeyMapper:
    """A Transformer2DModel at torch prefix ``tp`` (a regex whose groups
    ``fp`` may name) -> the port's ``transformer_2d`` subtree at ``fp``.
    SD1.5's proj_in / proj_out are 1x1 convs (use_linear_projection=False):
    their (O, I, 1, 1) weights stay 4-D, as ``layers.pointwise`` reads them."""
    g = _groups(tp)
    m.norm(tp + r"\.norm", fp + ".norm")
    m.module(tp + r"\.(proj_in|proj_out)", fp + rf".\g<{g + 1}>")
    bp, fq = tp + r"\.transformer_blocks\.([0-3])", fp + rf".blocks_\g<{g + 1}>"
    m.norm(bp + r"\.(norm[123])", fq + rf".\g<{g + 2}>")
    m.module(bp + r"\.(attn[12])\.(to_[qkv])", fq + rf".\g<{g + 2}>.\g<{g + 3}>")
    m.module(bp + r"\.(attn[12])\.to_out\.0", fq + rf".\g<{g + 2}>.to_out")
    m.module(bp + r"\.ff\.net\.0\.proj", fq + ".ff.proj_in")
    m.module(bp + r"\.ff\.net\.2", fq + ".ff.proj_out")
    return m


def _map_unet_resnet(m: KeyMapper, tp: str, fp: str) -> KeyMapper:
    g = _groups(tp)
    m.norm(tp + r"\.(norm[12])", fp + rf".\g<{g + 1}>")
    m.module(tp + r"\.(conv1|conv2|conv_shortcut|time_emb_proj)", fp + rf".\g<{g + 1}>")
    return m


def _unet_common_mapper(m: KeyMapper) -> KeyMapper:
    """The trunk the UNet and the ControlNet share (and a ControlLoRA ties)."""
    m.module(r"conv_in", "conv_in")
    m.module(r"time_embedding\.(linear_[12])", r"time_embedding.\1")
    _map_unet_resnet(m, r"down_blocks\.([0-3])\.resnets\.([0-2])", r"down_blocks_\1.resnets_\2")
    _map_transformer(m, r"down_blocks\.([0-3])\.attentions\.([0-2])",
                     r"down_blocks_\1.attentions_\2")
    m.module(r"down_blocks\.([0-3])\.downsamplers\.0\.conv", r"down_blocks_\1.downsamplers_0.conv")
    _map_unet_resnet(m, r"mid_block\.resnets\.([01])", r"mid_block.resnets_\1")
    _map_transformer(m, r"mid_block\.attentions\.0", "mid_block.attentions_0")
    return m


def port_unet_state_dict(sd) -> Dict:
    """diffusers UNet2DConditionModel state dict -> flat {path: leaf}."""
    m = _unet_common_mapper(KeyMapper())
    _map_unet_resnet(m, r"up_blocks\.([0-3])\.resnets\.([0-2])", r"up_blocks_\1.resnets_\2")
    _map_transformer(m, r"up_blocks\.([0-3])\.attentions\.([0-2])", r"up_blocks_\1.attentions_\2")
    m.module(r"up_blocks\.([0-3])\.upsamplers\.0\.conv", r"up_blocks_\1.upsamplers_0.conv")
    m.norm(r"conv_norm_out", "conv_norm_out")
    m.module(r"conv_out", "conv_out")
    return m.apply(sd)


def port_controlnet_state_dict(sd) -> Dict:
    """diffusers ControlNetModel state dict -> flat {path: leaf} of the
    ``controlnet_mode`` tree."""
    m = _unet_common_mapper(KeyMapper())
    m.module(r"controlnet_cond_embedding\.(conv_in|conv_out)", r"controlnet_cond_embedding.\1")
    m.module(r"controlnet_cond_embedding\.blocks\.([0-5])", r"controlnet_cond_embedding.blocks_\1")
    m.module(r"controlnet_down_blocks\.(\d|1[01])", r"controlnet_down_blocks_\1")
    m.module(r"controlnet_mid_block", "controlnet_mid_block")
    return m.apply(sd)
