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

On a mesh whose ranks hold slices or rows of some leaves, the caller names
them in a layout, {path: core/partitioning.py::Split} over the state's
flattened paths (core/partitioning.py::tp_layout gives a tree's
tensor-parallel ones): :func:`save_checkpoint` gathers each split leaf to
its global shape before rank 0 writes (as orbax writes global arrays, so
the file is the same whatever the mesh), and :func:`load_checkpoint_sharded`
gives each rank its slice or rows back in the template's place: the
counterpart of the JAX package's ``load_checkpoint_sharded``.

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
import torch.distributed as dist

from edgestyle_tpu_torch.core.device import DeviceLike, resolve_device
from edgestyle_tpu_torch.core.mesh import axis_index, axis_size, on_rank0
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.core.porting import from_jax_params, to_jax_params
from edgestyle_tpu_torch.core.safetensors import load_file, save_file

STATE_FILE = "state.pt"


def _dir(root: str, step: int) -> str:
    return os.path.join(root, f"checkpoint-{step}")


def _map(node, fn, prefix=()):
    """``node`` with every tensor leaf replaced by ``fn(path, leaf)``."""
    if isinstance(node, dict):
        return {k: _map(v, fn, prefix + (k,)) for k, v in node.items()}
    return fn(prefix, node) if isinstance(node, torch.Tensor) else node


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


def _gather(mesh, state: Dict[str, Any], layout: Dict) -> Dict[str, Any]:
    """``state`` with each leaf that ``layout`` names put together from the
    ranks of its mesh axis: one all-gather of the shares (exact bits, the
    sign of a zero too), each placed into the global tensor."""
    def gather(path, local):
        split = layout.get(path)
        if split is None:
            return local
        n = axis_size(mesh, split.axis)
        local = local.contiguous()
        shares = [torch.empty_like(local) for _ in range(n)]
        dist.all_gather(shares, local, group=mesh.get_group(split.axis))
        out = local.new_empty(split.global_shape(local.shape, n))
        for j, share in enumerate(shares):
            split.place(out, share, j, n)
        return out

    return _map(state, gather)


def save_checkpoint(root: str, state: Dict[str, Any], total_limit: Optional[int] = None,
                    mesh=None, layout: Optional[Dict] = None) -> str:
    """Write ``state`` to ``root/checkpoint-<step>/state.pt``; read it back
    and raise unless equal; keep the newest ``total_limit`` checkpoints.
    Under data parallelism rank 0 writes and the others wait at a barrier
    (the state is the same on every rank). With ``mesh`` and ``layout``
    (the two go together) every rank first takes part in gathering each
    split leaf to its global shape, and rank 0 writes the global state."""
    if (mesh is None) != (layout is None):
        raise ValueError("save_checkpoint: mesh and layout go together (the layout's "
                         "axes are the mesh's)")
    path = os.path.abspath(_dir(root, int(state["step"])))
    if layout:
        state = _gather(mesh, state, layout)
    on_rank0(_save, root, path, state, total_limit)
    return path


def _save(root: str, path: str, state: Dict[str, Any], total_limit: Optional[int]) -> None:
    os.makedirs(path, exist_ok=True)
    host = _map(state, lambda _, t: t.detach().cpu())
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
    return _map(state, lambda _, t: t.to(dev))


def load_checkpoint_sharded(root: str, template: Dict[str, Any], mesh,
                            step: Union[str, int] = "latest",
                            layout: Optional[Dict] = None) -> Dict[str, Any]:
    """The train state of ``checkpoint-<step>`` laid out like ``template``
    (the live state of this rank on ``mesh``): each tensor leaf in the
    template leaf's place, with its local shape, device, dtype and memory
    format, holding the global leaf where the template's is whole and this
    rank's slice or rows (by its coordinate on the ``layout`` entry's axis)
    where ``layout`` names it. Raises ValueError on a leaf whose shape is
    neither the global one nor, with a layout entry, a share of it; a file
    written on any mesh resumes onto any other."""
    state = load_checkpoint(root, step, device="cpu")
    layout = layout or {}
    flat = dict(_leaves(state))

    def restore(path, t):
        key = "/" + "/".join(path)
        if key not in flat:
            raise KeyError(f"{key}: in the template, not in the checkpoint")
        g = flat[key]
        split = layout.get(path)
        if split is None:
            if g.shape != t.shape:
                raise ValueError(f"{key}: the template's {tuple(t.shape)} is not the "
                                 f"checkpoint's {tuple(g.shape)} and the layout splits it not")
            local = g
        else:
            n = axis_size(mesh, split.axis)
            if tuple(g.shape) != split.global_shape(t.shape, n):
                raise ValueError(f"{key}: the template's {tuple(t.shape)} is no share of the "
                                 f"checkpoint's {tuple(g.shape)} over {n} {split.axis} ranks")
            local = split.take(g, axis_index(mesh, split.axis), n)
        return torch.empty_like(t).copy_(local)

    return _map(template, restore)


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
