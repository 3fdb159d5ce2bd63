"""Normalization ops with fp32 statistics.

Counterpart of edgestyle_tpu/ops/norms.py. Statistics are taken in fp32
whatever the input type; for bf16 inputs the mean and variance come from
one pass (E[x^2] - E[x]^2, clamped at 0), as the JAX package's ``_moments``
with ``fast=True`` does, and for fp32 inputs from torch's two-pass form.
Images are NCHW (channels_last memory); the statistics are taken over the
NHWC view, as the JAX package groups its trailing channel axis.
"""

from __future__ import annotations

from typing import Optional

import torch

F32 = torch.float32


def cast(x: Optional[torch.Tensor], dtype) -> Optional[torch.Tensor]:
    """``x.to(dtype)``, or x itself where it has that type already: an
    exported graph (core/export.py) keeps every ``.to`` call as two nodes,
    a no-op one too, and each node costs trace, save and load time."""
    return x if x is None or x.dtype == dtype else x.to(dtype)


def moments(xf: torch.Tensor, dims, fast: bool):
    """(mean, var) of fp32 ``xf`` over ``dims``, keepdim."""
    mean = xf.mean(dim=dims, keepdim=True)
    if fast:
        m2 = xf.square().mean(dim=dims, keepdim=True)
        var = torch.clamp(m2 - mean.square(), min=0.0)
    else:
        var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return mean, var


def use_fast(x: torch.Tensor) -> bool:
    return x.dtype == torch.bfloat16


def group_norm_stats(x: torch.Tensor, num_groups: int, eps: float):
    """Per-(batch, group) mean and 1/std of an NCHW image, fp32, each
    shaped (B, G)."""
    b, c = x.shape[:2]
    if c % num_groups:
        raise ValueError(f"channels {c} not divisible by groups {num_groups}")
    xf = cast(x, F32).permute(0, 2, 3, 1).reshape(b, -1, num_groups, c // num_groups)
    mean, var = moments(xf, (1, 3), fast=use_fast(x))
    return mean.reshape(b, num_groups), torch.rsqrt(var + eps).reshape(b, num_groups)


def group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               num_groups: int = 32, eps: float = 1e-5, act=None) -> torch.Tensor:
    """GroupNorm (+ optional activation) of an NCHW image, returned in x's
    dtype. scale/bias: (C,)."""
    b, c = x.shape[:2]
    mean, rstd = group_norm_stats(x, num_groups, eps)
    per = c // num_groups
    xf = cast(x, F32).permute(0, 2, 3, 1).reshape(b, -1, num_groups, per)
    xf = (xf - mean[:, None, :, None]) * rstd[:, None, :, None]
    out = xf.reshape(b, x.shape[2], x.shape[3], c) * cast(scale, F32) + cast(bias, F32)
    if act is not None:
        out = act(out)
    return cast(out, x.dtype).permute(0, 3, 1, 2)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the trailing axis, fp32 statistics, x's dtype out."""
    xf = cast(x, F32)
    mean, var = moments(xf, -1, fast=use_fast(x))
    out = (xf - mean) * torch.rsqrt(var + eps)
    out = out * cast(scale, F32) + cast(bias, F32)
    return cast(out, x.dtype)
