"""Image resizes of the preprocessing, on NCHW tensors.

Counterpart of edgestyle_tpu/ops/resize.py and of the two
``jax.image.resize(..., "bilinear")`` calls of the preprocessing
(``models/openpose.py::preprocess_for_openpose``, 512 -> 184, and
``models/efficientvit/sam.py::postprocess_masks``, 256 -> the image size):

  * :func:`torch_bicubic_resize` is torch's own a = -0.75 bicubic, which
    the JAX module emulates with two interpolation matrices (what the
    reference's EfficientViT UpSampleLayer runs in the SAM neck);
  * :func:`linear_resize` is ``jax.image.resize``'s bilinear: a triangle
    kernel with half-pixel centres, widened by the scale on a downscale
    (antialiasing), each output's weights renormalised to sum to 1. That is
    not ``F.interpolate(mode="bilinear")``, which never antialiases, nor
    exactly its ``antialias=True``. The weights are two small dense
    matrices built on the host (out x in per axis) and applied as matmuls
    in fp32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def torch_bicubic_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """x: (B, C, H, W) -> (B, C, oh, ow), bicubic (a = -0.75, half-pixel,
    edge-clamped taps, no antialiasing) computed in fp32, returned in x's
    dtype. Same size: x unchanged."""
    oh, ow = out_hw
    if tuple(x.shape[2:]) == (oh, ow):
        return x
    y = F.interpolate(x.float(), size=(oh, ow), mode="bicubic", align_corners=False)
    return y.to(x.dtype)


@functools.lru_cache(maxsize=None)
def _linear_weights(out_size: int, in_size: int) -> np.ndarray:
    """(out, in) fp32 weights of jax.image.resize's antialiased triangle
    kernel (``jax._src.image.scale.compute_weight_mat``), in its fp32
    arithmetic."""
    f32 = np.float32
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(out_size, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    dist = np.abs(sample[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - dist).astype(f32)  # (in, out)
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.ascontiguousarray(np.where(inside[None, :], w, f32(0.0)).T.astype(f32))


def linear_resize(x: torch.Tensor, out_hw) -> torch.Tensor:
    """x: (..., H, W) float -> (..., oh, ow) in fp32, as
    ``jax.image.resize(x, ..., method="bilinear")`` with its default
    antialiasing. An axis whose size does not change is left as it is."""
    oh, ow = out_hw
    h, w = x.shape[-2:]
    y = x.float()
    if h != oh:
        wy = torch.from_numpy(_linear_weights(oh, h)).to(y.device)
        y = torch.matmul(wy, y)
    if w != ow:
        wx = torch.from_numpy(_linear_weights(ow, w)).to(y.device)
        y = torch.matmul(y, wx.t())
    return y
