"""The tensor-parallel collectives of the ``model`` group.

Megatron's pair, as ``torch.autograd.Function``s: :class:`CopyToModel`
(identity forward, all-reduce of the gradient backward) on the replicated
input of a column-parallel Dense, and :class:`ReduceFromModel` (all-reduce
forward, identity backward) on the partial sums of a row-parallel Dense.
The layers (models/layers.py, models/clip_text.py) reach them only while
:func:`model_parallel` names a group and only where their kernels hold a
shard (core/partitioning.py); with no group they run as they did, with no
collective. ``ALL_REDUCES`` counts the forward collectives of the model
group and ``REDUCED_BYTES`` their bytes, ``BACKWARD_ALL_REDUCES`` and
``BACKWARD_BYTES`` those of :class:`CopyToModel`'s backward (chip_smoke
holds all four to the counts the code predicts). Under int8 serving a
row-parallel Dense sums its int32 accumulators (:func:`sum_from_model`,
exact) after :func:`max_over_model` has made its activation scale the
whole tensor's; both count as forward collectives.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_GROUP: Optional[dist.ProcessGroup] = None
ALL_REDUCES = [0]
REDUCED_BYTES = [0]
BACKWARD_ALL_REDUCES = [0]
BACKWARD_BYTES = [0]


@contextlib.contextmanager
def model_parallel(group: dist.ProcessGroup):
    """Run the block's layers tensor-parallel over ``group``."""
    global _GROUP
    before, _GROUP = _GROUP, group
    try:
        yield
    finally:
        _GROUP = before


def group() -> Optional[dist.ProcessGroup]:
    """The active model group, None outside :func:`model_parallel`."""
    return _GROUP


def index() -> int:
    """This rank's coordinate in the active model group."""
    return dist.get_rank(_require())


def size() -> int:
    """The ranks of the active model group, 1 outside :func:`model_parallel`."""
    return 1 if _GROUP is None else dist.get_world_size(_GROUP)


def _all_reduce(x: torch.Tensor, grp, op=dist.ReduceOp.SUM) -> torch.Tensor:
    dist.all_reduce(x, op=op, group=grp)
    return x


def _count(x: torch.Tensor) -> None:
    ALL_REDUCES[0] += 1
    REDUCED_BYTES[0] += x.numel() * x.element_size()


class CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        BACKWARD_ALL_REDUCES[0] += 1
        BACKWARD_BYTES[0] += grad.numel() * grad.element_size()
        return _all_reduce(grad.clone(), ctx.grp), None


class ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        _count(x)
        return _all_reduce(x.clone(), grp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return CopyToModel.apply(x, _require())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return ReduceFromModel.apply(x, _require())


def sum_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of a tensor with no gradient (int8's
    int32 accumulators: an exact sum), in place."""
    _count(x)
    return _all_reduce(x, _require())


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max over the model group (an activation's absmax, a
    weight shard's per-row absmax), in place."""
    _count(x)
    return _all_reduce(x, _require(), dist.ReduceOp.MAX)


def _require() -> dist.ProcessGroup:
    if _GROUP is None:
        raise RuntimeError("a sharded Dense kernel outside model_parallel(): its partial "
                           "sums need the model group")
    return _GROUP
