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
  * LoRA adapters ``{down, up}`` (models/unet.py): linear down (in, r) ->
    (r, in) and up (r, out) -> (out, r); conv down (kh, kw, in, r) ->
    (r, in, kh, kw);
  * norm scale/bias and LoRA adapters stay fp32; every other leaf takes the
    compute dtype.

:func:`from_jax_train_state` carries a JAX ControlLoRA train state across:
the trainables and the Prodigy state's trees in fp32, its scalars as 0-d
fp32 tensors and the step as a host int.

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


def _lora_leaf(arr: np.ndarray) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(arr, dtype=np.float32)))
    if t.ndim == 4:  # conv down (kh, kw, in, r)
        return t.permute(3, 2, 0, 1)
    return t.t()


def from_jax_params(tree: Mapping, device: DeviceLike = "cuda",
                    dtype: torch.dtype = torch.float32) -> dict:
    """Nested dict of numpy arrays (Flax layout) -> nested dict of tensors
    (the port's layout) on ``device``."""
    dev = resolve_device(device)

    def convert(node: Mapping) -> dict:
        is_norm = "scale" in node and not isinstance(node["scale"], Mapping)
        is_lora = set(node) == {"down", "up"} and not isinstance(node["down"], Mapping)
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = convert(v)
                continue
            t = _lora_leaf(v) if is_lora else _leaf(k, v, is_norm)
            t = t.to(device=dev, dtype=torch.float32 if is_norm or is_lora else dtype)
            if t.ndim == 4:
                t = t.contiguous(memory_format=torch.channels_last)
            else:
                t = t.contiguous()
            out[k] = t
        return out

    return convert(tree)


PRODIGY_TREES = ("exp_avg", "exp_avg_sq", "s", "p0")
PRODIGY_SCALARS = ("d", "d_max", "d_numerator")


def from_jax_train_state(state: Mapping, device: DeviceLike = "cuda") -> dict:
    """A JAX ControlLoRA train state ``{trainable, opt_state, step}`` as
    numpy (``jax.tree.map(np.asarray, state)``), with a Prodigy optimizer,
    -> the port's state (training/train_step.py). The Prodigy state is found
    in ``opt_state`` by its fields (the optax chain puts it after the
    clipping's empty state). Every tree is fp32, whatever the compute
    dtype."""
    def find(node):
        fields = getattr(node, "_asdict", None)
        if fields is not None and "d_max" in node._fields:
            return fields()
        if isinstance(node, (tuple, list)):
            for x in node:
                got = find(x)
                if got is not None:
                    return got
        return None

    prodigy = find(state["opt_state"])
    if prodigy is None:
        raise ValueError("no Prodigy state (fields d, d_max, ...) in opt_state")
    dev = resolve_device(device)
    opt = {k: from_jax_params(prodigy[k], dev, torch.float32) for k in PRODIGY_TREES}
    opt.update({k: torch.tensor(float(np.asarray(prodigy[k])), dtype=torch.float32, device=dev)
                for k in PRODIGY_SCALARS})
    opt["step"] = int(np.asarray(prodigy["step"]))
    return {"trainable": from_jax_params(state["trainable"], dev, torch.float32),
            "opt_state": opt, "step": int(np.asarray(state["step"]))}
