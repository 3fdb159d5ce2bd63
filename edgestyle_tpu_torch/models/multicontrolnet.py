"""EdgeStyle multi-branch ControlNet: batched trunks, interleave, fusion.

Counterpart of edgestyle_tpu/models/multicontrolnet.py. Each branch gives
12 down residuals and a mid residual; per skip position the N branch
tensors are channel-interleaved (index c*N + n) and a trainable fusion
block maps N*C -> C: grouped 1x1 (pairs of nets per channel) -> LayerNorm
over the whole (C, H, W) extent -> SiLU -> grouped 1x1 -> LN -> SiLU ->
per-channel 1x1. Branches that share params run as one batched trunk call:
for the pattern (0, None, 1, None, 1, None) that is openpose x3, loraB x2
and loraA, three calls instead of six.

The fusion blocks work on the NHWC view of the interleaved residuals,
where the per-group sums are plain reshapes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from edgestyle_tpu_torch.core import spans
from edgestyle_tpu_torch.core.params import param, sub
from edgestyle_tpu_torch.models.unet import SD15UNet, UNetConfig
from edgestyle_tpu_torch.ops.norms import cast, moments, use_fast

CONTROLNET_PATTERN = (0, None, 1, None, 1, None)


def interleave_residuals(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Channel-interleave N same-shape NCHW tensors: out channel c*N + n."""
    stacked = torch.stack(tensors, dim=2)  # (B, C, N, H, W)
    b, c, n, h, w = stacked.shape
    return stacked.reshape(b, c * n, h, w)


def full_layer_norm(p, x: torch.Tensor) -> torch.Tensor:
    """torch nn.LayerNorm([C, H, W]) on an NHWC tensor; the params are
    stored (C, H, W)."""
    b, h, w, c = x.shape
    scale = param(p, "scale", (c, h, w), "ones", fp32=True).permute(1, 2, 0)
    bias = param(p, "bias", (c, h, w), "zeros", fp32=True).permute(1, 2, 0)
    xf = cast(x, torch.float32)
    mean, var = moments(xf, (1, 2, 3), fast=use_fast(x))
    out = (xf - mean) * torch.rsqrt(var + 1e-5) * scale + bias
    return cast(out, x.dtype)


def grouped_pointwise(p, x: torch.Tensor, groups: int, in_per_group: int, dtype):
    """Grouped 1x1 conv on an NHWC tensor (weight (groups, in_per_group, 1,
    1), as torch's grouped Conv2d): out[g] = sum_i x[g*in_per_group + i] *
    w[g, i] + bias[g], summed in fp32."""
    w = param(p, "kernel", (groups, in_per_group, 1, 1))
    b = param(p, "bias", (groups,), "zeros")
    cin = x.shape[-1]
    if cin != groups * in_per_group:
        raise ValueError(f"grouped 1x1 expects {groups * in_per_group} input channels "
                         f"({groups} groups x {in_per_group} per group), got {cin}")
    f32 = torch.float32
    xr = cast(x, dtype).reshape(*x.shape[:3], groups, in_per_group)
    out = (cast(xr, f32) * cast(cast(w, dtype), f32).view(groups, in_per_group)).sum(-1)
    return cast(out, dtype) + cast(b, dtype)


def fusion_block(p, x: torch.Tensor, channels: int, num_nets: int, dtype) -> torch.Tensor:
    """N*C -> C fusion of one skip position, NHWC in and out."""
    c, n = channels, num_nets
    x = grouped_pointwise(sub(p, "first_conv"), x, c * n // 2, 2, dtype)
    x = F.silu(full_layer_norm(sub(p, "first_normalization"), x))
    x = grouped_pointwise(sub(p, "second_conv"), x, c, n // 2, dtype)
    x = F.silu(full_layer_norm(sub(p, "second_normalization"), x))
    return grouped_pointwise(sub(p, "third_conv"), x, c, 1, dtype)


def edgestyle_fusion(p, down_lists, mid_list, down_channels: Sequence[int], mid_channels: int,
                     dtype):
    """The 12 down + 1 mid fusion blocks. down_lists: per-branch lists of
    NCHW residuals; returns (fused down tuple, fused mid), NCHW."""
    n = len(down_lists)
    def fuse(name, tensors, ch):
        nhwc = interleave_residuals(tensors).permute(0, 2, 3, 1)
        return fusion_block(sub(p, name), nhwc, ch, n, dtype).permute(0, 3, 1, 2)

    fused = tuple(fuse(f"multi_controlnet_down_blocks_{k}", [d[k] for d in down_lists], ch)
                  for k, ch in enumerate(down_channels))
    return fused, fuse("multi_controlnet_mid_block", mid_list, mid_channels)


@dataclasses.dataclass(frozen=True)
class BranchGroup:
    """Branch positions that share one param tree (one batched trunk call)."""

    positions: Tuple[int, ...]
    params_key: str
    kind: str  # 'lora' (latent cond) | 'static' (conv cond)


def pattern_groups(pattern: Sequence[Optional[int]] = CONTROLNET_PATTERN):
    """None -> the one static net; integer id -> that ControlLoRA."""
    by_key: Dict[str, List[int]] = {}
    kinds: Dict[str, str] = {}
    for pos, pid in enumerate(pattern):
        key = "static" if pid is None else f"lora_{pid}"
        by_key.setdefault(key, []).append(pos)
        kinds[key] = "static" if pid is None else "lora"
    return tuple(BranchGroup(tuple(v), k, kinds[k]) for k, v in sorted(by_key.items()))


class EdgeStyleMultiControlNet:
    """params: {'static', 'lora_0', 'lora_1', ..., 'fusion'}; cond inputs
    are the precomputed 320-channel embeddings. ``tome`` (ops/tome.py)
    goes to the trunks' transformer blocks."""

    def __init__(self, cfg: UNetConfig = UNetConfig(),
                 pattern: Sequence[Optional[int]] = CONTROLNET_PATTERN,
                 dtype: torch.dtype = torch.float32, tome=None):
        self.cfg = cfg
        self.pattern = tuple(pattern)
        self.groups = pattern_groups(pattern)
        self.dtype = dtype
        self.branch = SD15UNet(cfg, controlnet_mode=True, dtype=dtype, tome=tome)
        self.down_channels = tuple(self.branch.skip_channels())

    def __call__(self, params, sample, timesteps, encoder_hidden_states, cond_embeddings,
                 conditioning_scale: Optional[Sequence[float]] = None,
                 guess_mode: bool = False):
        """Returns (12 fused down residuals, fused mid residual).
        ``conditioning_scale``: host per-branch floats."""
        with spans.span(spans.MCN):
            n = len(self.pattern)
            scales = np.ones((n,), np.float32) if conditioning_scale is None else \
                np.asarray(conditioning_scale, np.float32)
            b = sample.shape[0]
            if timesteps.ndim == 0:
                timesteps = timesteps.expand(b)
            depth = len(self.down_channels) + 1
            gs = (np.logspace(-1.0, 0.0, depth).astype(np.float32) if guess_mode
                  else np.ones((depth,), np.float32))
            down_per_branch: List = [None] * n
            mid_per_branch: List = [None] * n
            for grp in self.groups:
                k = len(grp.positions)
                down, mid = self.branch.controlnet_forward(
                    sub(params, grp.params_key),
                    torch.cat([sample] * k), torch.cat([timesteps] * k),
                    torch.cat([encoder_hidden_states] * k),
                    torch.cat([cond_embeddings[p] for p in grp.positions]),
                )
                for j, p in enumerate(grp.positions):
                    sl = slice(j * b, (j + 1) * b)
                    down_per_branch[p] = [d[sl].float() * float(scales[p] * gs[i])
                                          for i, d in enumerate(down)]
                    mid_per_branch[p] = mid[sl].float() * float(scales[p] * gs[-1])
            with spans.span(spans.MCN_FUSION):
                return edgestyle_fusion(sub(params, "fusion"), down_per_branch, mid_per_branch,
                                        self.down_channels, self.cfg.block_out_channels[-1],
                                        self.dtype)
