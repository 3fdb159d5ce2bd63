"""JAX param trees -> the port's param trees.

The JAX pipeline's params (``{vae, clip, unet, controlnet{static, lora_0,
lora_1, fusion}}``, edgestyle_tpu/pipelines/tryon.py) are nested dicts of
arrays in Flax layouts. Converted to numpy (``jax.tree.map(np.asarray,
params)``), :func:`from_jax_params` turns them into the port's tree: the
same keys, with each leaf re-laid out for PyTorch:

  * conv kernel HWIO -> OIHW, stored ``channels_last`` (memory O,H,W,I,
    which is what the fused conv kernel reads);
  * the fusion blocks' grouped 1x1 kernels ``(1, 1, in_per_group, groups)``
    -> ``(groups, in_per_group, 1, 1)``, the weight of a torch grouped conv
    with ``groups`` groups. That is the same HWIO -> OIHW transpose, and it
    keeps the channel pairing: output g reads inputs g*in_per_group + i;
  * Dense kernel (in, out) -> (out, in);
  * FullLayerNorm scale/bias (H, W, C) -> (C, H, W);
  * norm scale/bias stay fp32; every other leaf takes the compute dtype.

This module and the tests are the only places that know the JAX layouts.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, resolve_device


def _leaf(name: str, arr: np.ndarray, is_norm: bool) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(arr, dtype=np.float32)))
    if name == "kernel" and t.ndim == 4:
        return t.permute(3, 2, 0, 1)
    if name == "kernel" and t.ndim == 2:
        return t.t()
    if is_norm and t.ndim == 3:
        return t.permute(2, 0, 1)
    return t


def from_jax_params(tree: Mapping, device: DeviceLike = "cuda",
                    dtype: torch.dtype = torch.float32) -> dict:
    """Nested dict of numpy arrays (Flax layout) -> nested dict of tensors
    (the port's layout) on ``device``."""
    dev = resolve_device(device)

    def convert(node: Mapping) -> dict:
        is_norm = "scale" in node and not isinstance(node["scale"], Mapping)
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = convert(v)
                continue
            t = _leaf(k, v, is_norm)
            t = t.to(device=dev, dtype=torch.float32 if is_norm else dtype)
            if t.ndim == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            else:
                t = t.contiguous()
            out[k] = t
        return out

    return convert(tree)
