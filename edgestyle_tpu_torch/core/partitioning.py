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
JAX's guard keeps it. :func:`tp_layout` names each split leaf's
:class:`Split` (the rule's one statement: :func:`local_shard`, the LoRA
merge of models/unet.py and the checkpoint's gather and resume read it).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from edgestyle_tpu_torch.core.mesh import MODEL_AXIS, axis_index, axis_size
from edgestyle_tpu_torch.core.params import flatten, unflatten
from edgestyle_tpu_torch.ops.quant import QuantKernel, is_prequant

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


@dataclasses.dataclass(frozen=True)
class Split:
    """How a leaf is split over the ranks of a mesh axis: along ``dim``, in
    ``parts`` blocks each split on its own (GEGLU's [hidden | gate]: 2),
    rank i of n keeping share i of every block."""
    axis: str
    dim: int
    parts: int = 1

    def take(self, v: torch.Tensor, index: int, size: int) -> torch.Tensor:
        """Rank ``index`` of ``size``'s share of the global ``v``."""
        n = v.shape[self.dim] // self.parts
        k = n // size
        blocks = [v.narrow(self.dim, j * n + index * k, k) for j in range(self.parts)]
        return torch.cat(blocks, dim=self.dim) if self.parts > 1 else blocks[0].contiguous()

    def global_shape(self, local_shape, size: int) -> Tuple[int, ...]:
        shape = list(local_shape)
        shape[self.dim] *= size
        return tuple(shape)

    def place(self, out: torch.Tensor, local: torch.Tensor, index: int, size: int) -> None:
        """Write rank ``index``'s share ``local`` into the global ``out``."""
        k = local.shape[self.dim] // self.parts
        n = k * size
        for j in range(self.parts):
            out.narrow(self.dim, j * n + index * k, k).copy_(local.narrow(self.dim, j * k, k))


def kernel_split(path: Tuple[str, ...], shape, size: int,
                 num_heads: Optional[int] = None) -> Optional[Split]:
    """The :class:`Split` over ``model`` of a Dense kernel (port layout,
    (out, in)) at ``path`` of global ``shape``, or None where it stays
    whole: no rule, one rank, an attention kernel whose ``num_heads`` do
    not divide ``size``, or a split dimension that does not divide."""
    spec = tp_spec_for_path(".".join(path), len(shape))
    if not spec or size == 1:
        return None
    if num_heads is not None and num_heads % size and path[-2] in _ATTENTION:
        return None
    split = Split(MODEL_AXIS, 0 if spec == COLUMN else 1,
                  2 if path[-3:-1] == ("ff", "proj_in") else 1)
    if (shape[split.dim] // split.parts) % size:
        return None
    return split


def tp_layout(params: Dict, size: int, num_heads: Optional[int] = None) -> Dict:
    """{path: :class:`Split`} of every leaf of ``params`` that
    :func:`local_shard` splits over ``size`` model ranks: the kernels of
    :func:`kernel_split` and a column-parallel kernel's bias (with its
    rows). A :class:`~edgestyle_tpu_torch.ops.quant.QuantKernel` leaf
    splits as its kernel."""
    flat = flatten(params)
    out = {}
    for path, v in flat.items():
        shape = v.q.shape if is_prequant(v) else v.shape
        split = kernel_split(path, shape, size, num_heads)
        if split is None:
            continue
        out[path] = split
        bias = path[:-1] + ("bias",)
        if split.dim == 0 and bias in flat:
            out[bias] = split
    return out


def local_shard(params: Dict, index: int, size: int, num_heads: Optional[int] = None) -> Dict:
    """Rank ``index`` of ``size``'s tensor-parallel slices of ``params``
    (:func:`tp_layout`): a column-parallel kernel keeps rows index*n/size..
    of its n outputs (GEGLU: of each half) and its bias the same, a
    row-parallel kernel the matching columns; every other leaf is the
    caller's tensor. A pre-quantised kernel keeps the same share of its
    int8 ``q``, and of its per-output-channel scale ``s`` where its outputs
    are split (column-parallel); a row-parallel one keeps ``s`` whole, the
    scale of the full kernel's rows."""
    flat = flatten(params)
    for path, split in tp_layout(params, size, num_heads).items():
        v = flat[path]
        if is_prequant(v):
            s = split.take(v.s, index, size) if split.dim == 0 else v.s
            flat[path] = QuantKernel(split.take(v.q, index, size), s, v.key)
        else:
            flat[path] = split.take(v, index, size)
    return unflatten(flat)


def shard_params_tp(mesh, params: Dict, num_heads: Optional[int] = None) -> Dict:
    """This rank's :func:`local_shard` of ``params`` by its ``model``
    coordinate on ``mesh`` (replicated over ``data``)."""
    return local_shard(params, axis_index(mesh, MODEL_AXIS), axis_size(mesh, MODEL_AXIS),
                       num_heads)


def shard_pipeline_frozen_tp(mesh, frozen: Dict, num_heads: Dict[str, Optional[int]]) -> Dict:
    """The train step's frozen set ({vae, clip, unet, static}) for a DP x TP
    step on the (data, model) ``mesh``: each submodel's
    :func:`shard_params_tp` with its head count (``num_heads[name]``, as
    ``generate_tp`` passes them: the VAE's single head keeps its attention
    whole). The counterpart of the JAX package's
    ``shard_pipeline_frozen_tp``; the trainables stay whole on every rank
    (training/train_step.py::make_train_step's ``model_group``)."""
    return {k: shard_params_tp(mesh, v, num_heads.get(k)) for k, v in frozen.items()}
