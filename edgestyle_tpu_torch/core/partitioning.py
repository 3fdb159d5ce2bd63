"""Tensor-parallel parameter sharding rules (the ``model`` mesh axis).

Counterpart of edgestyle_tpu/core/partitioning.py, with its path-suffix
rules: the attention q/k/v kernels, ``ff.proj_in`` and ``fc1`` are
column-parallel, ``to_out``, ``ff.proj_out`` and ``fc2`` row-parallel, and
everything else (every conv and norm too) is replicated.
:func:`tp_spec_for_path` answers as the JAX function does, over JAX's
(in, out) Dense kernel. The port's Dense kernels are (out, in)
(core/porting.py), so a column-parallel kernel splits its dim 0 and a
row-parallel one its dim 1.

JAX places the specs and GSPMD makes any split correct; here a rank keeps
its slice and the layers run megatron's collectives (ops/tp.py), so the
placement differs from JAX's in three places, the result not:

* GEGLU: ``ff.proj_in``'s 8C outputs are [hidden | gate], which the layer
  chunks in two; each half is split on its own, so a rank holds the same
  share of both, and ``ff.proj_out``'s columns match the hidden share;
* an attention whose heads do not divide the model axis (the VAE's single
  head) stays replicated when its head count is given, since a rank must
  hold whole heads;
* a column-parallel Dense's bias is sliced with its rows; a row-parallel
  one's stays whole and is added once, after the all-reduce.

A dimension that does not divide the model axis stays replicated, as
JAX's guard keeps it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from edgestyle_tpu_torch.core.mesh import MODEL_AXIS, axis_index, axis_size
from edgestyle_tpu_torch.core.params import flatten, unflatten

_COL_SUFFIXES = ("to_q.kernel", "to_k.kernel", "to_v.kernel",
                 "ff.proj_in.kernel", "fc1.kernel")
_ROW_SUFFIXES = ("to_out.kernel", "ff.proj_out.kernel", "fc2.kernel")
_ATTENTION = ("to_q", "to_k", "to_v", "to_out")
COLUMN = (None, MODEL_AXIS)
ROW = (MODEL_AXIS, None)


def tp_spec_for_path(path: str, ndim: int) -> Tuple:
    """The JAX package's PartitionSpec of a leaf, as a tuple over the (in,
    out) Dense kernel: :data:`COLUMN`, :data:`ROW` or () (replicated)."""
    if ndim == 2:
        if path.endswith(_COL_SUFFIXES):
            return COLUMN
        if path.endswith(_ROW_SUFFIXES):
            return ROW
    return ()


def local_shard(params: Dict, index: int, size: int, num_heads: Optional[int] = None) -> Dict:
    """Rank ``index`` of ``size``'s tensor-parallel slices of ``params``:
    a column-parallel kernel keeps rows index*n/size.. of its n outputs
    (GEGLU: of each half) and its bias the same, a row-parallel kernel the
    matching columns; every other leaf is the caller's tensor. An attention
    kernel (``to_q/k/v/out``) stays whole where ``num_heads`` does not
    divide ``size``; any kernel where its split dimension does not."""
    flat = flatten(params)
    out = dict(flat)
    for path, v in flat.items():
        spec = tp_spec_for_path(".".join(path), v.ndim)
        if not spec or size == 1:
            continue
        if num_heads is not None and num_heads % size and path[-2] in _ATTENTION:
            continue
        dim = 0 if spec == COLUMN else 1
        geglu = path[-3:-1] == ("ff", "proj_in")
        parts = 2 if geglu else 1
        n = v.shape[dim] // parts
        if n % size:
            continue
        out[path] = _slice(v, dim, parts, n, index, size)
        bias = path[:-1] + ("bias",)
        if spec == COLUMN and bias in flat:
            out[bias] = _slice(flat[bias], 0, parts, n, index, size)
    return unflatten(out)


def _slice(v: torch.Tensor, dim: int, parts: int, n: int, index: int, size: int):
    """Share ``index`` of ``size`` of each of ``parts`` blocks of ``n`` along
    ``dim``, concatenated."""
    k = n // size
    blocks = [v.narrow(dim, j * n + index * k, k) for j in range(parts)]
    return torch.cat(blocks, dim=dim) if parts > 1 else blocks[0].contiguous()


def shard_params_tp(mesh, params: Dict, num_heads: Optional[int] = None) -> Dict:
    """This rank's :func:`local_shard` of ``params`` by its ``model``
    coordinate on ``mesh`` (replicated over ``data``)."""
    return local_shard(params, axis_index(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS),
                       num_heads)
