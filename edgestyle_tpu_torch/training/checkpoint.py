"""Checkpoint and resume of the trainer's state.

Counterpart of edgestyle_tpu/training/checkpoint.py with its semantics:
only the train state {trainable, opt_state, step} is written (the frozen
weights never are); the save reads back what it wrote and raises unless
it is equal; ``checkpoint-<step>`` directories rotate under a total limit;
``latest`` resumes from the newest step. The format is ``torch.save`` of
the state moved to the host (one ``state.pt`` per directory), read back
with ``weights_only=True``. Under data parallelism (core/mesh.py) rank 0
writes the checkpoints and exports while the other ranks wait, and every
rank resumes onto its own device.

The deployable artifact is :func:`export_safetensors`: the trainable set
as one flat safetensors file in the JAX package's layout (its
``export_safetensors``), so that either package loads what the other
wrote; core/pretrained.py::export_reference_layout writes the
reference's directory layout.
"""

from __future__ import annotations

import os
import re
import shutil
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from edgestyle_tpu_torch.core.device import DeviceLike, resolve_device
from edgestyle_tpu_torch.core.mesh import on_rank0
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.core.safetensors import load_file, save_file

STATE_FILE = "state.pt"


def _dir(root: str, step: int) -> str:
    return os.path.join(root, f"checkpoint-{step}")


def _map(node, fn):
    if isinstance(node, dict):
        return {k: _map(v, fn) for k, v in node.items()}
    return fn(node) if isinstance(node, torch.Tensor) else node


def _leaves(node, prefix=""):
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, f"{prefix}/{k}")
    else:
        yield prefix, node


def states_equal(a, b) -> bool:
    """Same keys, equal tensors (bitwise, same dtype and shape) and equal
    host values."""
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    if la.keys() != lb.keys():
        return False
    for k, x in la.items():
        y = lb[k]
        if isinstance(x, torch.Tensor) != isinstance(y, torch.Tensor):
            return False
        if isinstance(x, torch.Tensor):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x.cpu(), y.cpu()):
                return False
        elif x != y:
            return False
    return True


def save_checkpoint(root: str, state: Dict[str, Any], total_limit: Optional[int] = None) -> str:
    """Write ``state`` to ``root/checkpoint-<step>/state.pt``; read it back
    and raise unless equal; keep the newest ``total_limit`` checkpoints.
    Under data parallelism rank 0 writes and the others wait at a barrier
    (the state is the same on every rank)."""
    path = os.path.abspath(_dir(root, int(state["step"])))
    on_rank0(_save, root, path, state, total_limit)
    return path


def _save(root: str, path: str, state: Dict[str, Any], total_limit: Optional[int]) -> None:
    os.makedirs(path, exist_ok=True)
    host = _map(state, lambda t: t.detach().cpu())
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save(host, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))
    back = torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)
    if not states_equal(host, back):
        raise RuntimeError(f"checkpoint round-trip mismatch at {path}")
    if total_limit is not None:
        steps = list_checkpoints(root)
        for s in steps[: max(0, len(steps) - total_limit)]:
            shutil.rmtree(_dir(root, s), ignore_errors=True)


def list_checkpoints(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    steps = []
    for d in os.listdir(root):
        m = re.fullmatch(r"checkpoint-(\d+)", d)
        if m:
            steps.append(int(m.group(1)))
    return sorted(steps)


def load_checkpoint(root: str, step: Union[str, int] = "latest",
                    device: DeviceLike = "cuda") -> Dict[str, Any]:
    """The train state of ``checkpoint-<step>`` (``latest``: the newest),
    its tensors on ``device`` (each rank reads it onto its own)."""
    if step == "latest":
        steps = list_checkpoints(root)
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
        step = steps[-1]
    dev = resolve_device(device)
    path = os.path.join(os.path.abspath(_dir(root, int(step))), STATE_FILE)
    state = torch.load(path, map_location="cpu", weights_only=True)
    return _map(state, lambda t: t.to(dev))


def export_safetensors(path: str, trainable: Dict[str, Any]) -> None:
    """The trainable set (adapters, heads, fusion) -> one safetensors file of
    flat dotted keys with the JAX package's Flax leaves (HWIO convs, (in,
    out) Dense and adapters, (H, W, C) LayerNorms; core/porting.py::
    to_jax_params), fp32: the file the JAX package's ``export_safetensors``
    writes for the same weights. Written by rank 0 under data parallelism."""
    on_rank0(_export, path, trainable)


def _export(path: str, trainable: Dict[str, Any]) -> None:
    flat = {".".join(k): torch.from_numpy(v) for k, v in flatten(to_jax_params(trainable)).items()}
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    save_file(flat, path)


def import_safetensors(path: str, device: DeviceLike = "cuda") -> Dict[str, Any]:
    """A trainable set exported by either package -> the port's tree, fp32
    on ``device`` (core/porting.py::from_jax_params)."""
    flat = {tuple(k.split(".")): np.asarray(v.float().numpy())
            for k, v in load_file(path).items()}
    return from_jax_params(unflatten(flat), device, torch.float32)
