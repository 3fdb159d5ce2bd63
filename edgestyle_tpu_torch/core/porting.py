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
  * ConvTranspose kernels (the SAM mask decoder's ``upscale_conv1/2``,
    :data:`CONV_TRANSPOSE_NODES`), flax (kH, kW, I, O) with the spatial flip
    the JAX port mapper applies -> torch's conv_transpose2d (I, O, kH, kW),
    unflipped. The generic conv rule would give (O, I, kH, kW): wrong in
    shape, and for a square layer wrong only in its flip;
  * grouped and depthwise conv kernels (kh, kw, in_per_group, out) take the
    conv rule, which gives torch's grouped (out, in_per_group, kh, kw);
  * norm leaves (a node with a ``scale``: LayerNorm, GroupNorm, and
    BatchNorm's scale, bias, mean and var) and LoRA adapters stay fp32;
    every other leaf takes the compute dtype.

:func:`from_jax_train_state` carries a JAX ControlLoRA train state across:
the trainables and the Prodigy state's trees in fp32, its scalars as 0-d
fp32 tensors and the step as a host int.

Checkpoints in torch's own layouts (the upstream SAM and body-pose
state dicts) come in through :func:`load_state_dict`, a model's key
renaming (:func:`rename_keys`, e.g. ``models/efficientvit/sam.py::
port_sam_state_dict``) and :func:`tree_from_flat`, with no re-layout.

This module and the tests are the only places that know the JAX layouts.
"""

from __future__ import annotations

import pickle
import re
from typing import Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, resolve_device


CONV_TRANSPOSE_NODES = ("upscale_conv1", "upscale_conv2")


def _leaf(name: str, arr: np.ndarray, is_norm: bool, transpose_conv: bool = False) -> torch.Tensor:
    a = np.asarray(arr, dtype=np.float32)
    if transpose_conv and name == "kernel":
        # flax (kH, kW, I, O), flipped by the JAX port mapper -> (I, O, kH, kW)
        return torch.from_numpy(np.ascontiguousarray(a[::-1, ::-1].transpose(2, 3, 0, 1)))
    t = torch.from_numpy(np.ascontiguousarray(a))
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

    def convert(node: Mapping, name: str = "") -> dict:
        is_norm = _is_norm(node)
        is_lora = set(node) == {"down", "up"} and not isinstance(node["down"], Mapping)
        out = {}
        for k, v in node.items():
            if isinstance(v, Mapping):
                out[k] = convert(v, k)
                continue
            t = (_lora_leaf(v) if is_lora
                 else _leaf(k, v, is_norm, name in CONV_TRANSPOSE_NODES))
            out[k] = _place(t, dev, torch.float32 if is_norm or is_lora else dtype)
        return out

    return convert(tree)


def _is_norm(node: Mapping) -> bool:
    return "scale" in node and not isinstance(node["scale"], Mapping)


def _place(t: torch.Tensor, dev: torch.device, dtype: torch.dtype) -> torch.Tensor:
    t = t.to(device=dev, dtype=dtype)
    if t.ndim == 4:
        return t.contiguous(memory_format=torch.channels_last)
    return t.contiguous()


# ------------------------------------------------ torch-layout checkpoints
def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A weights-only torch checkpoint (.pt / .pth / .ckpt) -> numpy state
    dict. Takes a raw ``state_dict()`` or one wrapped under ``"state_dict"``
    (the reference's save layouts); full pickled modules are refused."""
    if path.endswith(".safetensors"):
        raise NotImplementedError(
            f"{path}: the safetensors reader is not ported yet (ROADMAP.md Queue 1 item 1b); "
            "pass a .pt/.pth state dict")
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:  # a pickled module or other non-tensor objects
        raise ValueError(f"{path}: not a weights-only torch checkpoint ({e}); save "
                         "module.state_dict() instead of the module") from e
    if isinstance(ckpt, dict) and "state_dict" in ckpt:
        ckpt = ckpt["state_dict"]
    if not isinstance(ckpt, dict):
        raise ValueError(f"{path}: expected a state dict, got {type(ckpt)}")
    return {k: v.detach().cpu().float().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in ckpt.items()}


def rename_keys(sd: Mapping, rules: Sequence[Tuple[re.Pattern, Optional[str]]]
                ) -> Dict[str, np.ndarray]:
    """Torch keys -> the port's dotted paths, leaves unchanged (as numpy).
    Each key takes its first rule whose regex matches it whole; a template
    of None drops the key. A key no rule matches raises, so a checkpoint is
    never loaded with weights silently left out."""
    out, unmatched = {}, []
    for k, v in sd.items():
        for pat, template in rules:
            m = pat.fullmatch(k)
            if m:
                if template is not None:
                    out[m.expand(template)] = (v.detach().cpu().numpy()
                                               if isinstance(v, torch.Tensor) else np.asarray(v))
                break
        else:
            unmatched.append(k)
    if unmatched:
        raise KeyError(f"unported torch keys ({len(unmatched)}): {unmatched[:10]}")
    return out


def tree_from_flat(flat: Mapping[str, np.ndarray], device: DeviceLike = "cuda",
                   dtype: torch.dtype = torch.float32) -> dict:
    """{dotted path: array in the port's layout} -> nested dict of tensors on
    ``device``: norm leaves fp32, the rest ``dtype``, 4-D tensors
    channels_last."""
    dev = resolve_device(device)
    tree: dict = {}
    for path, v in flat.items():
        node = tree
        *parents, leaf = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[leaf] = torch.from_numpy(np.ascontiguousarray(np.asarray(v, dtype=np.float32)))

    def place(node: dict) -> dict:
        is_norm = _is_norm(node)
        return {k: place(v) if isinstance(v, dict)
                else _place(v, dev, torch.float32 if is_norm else dtype)
                for k, v in node.items()}

    return place(tree)


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
