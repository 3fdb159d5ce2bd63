"""The tensor-parallel collectives of the ``model`` group.

Megatron's pair, as ``torch.autograd.Function``s: :class:`CopyToModel`
(identity forward, all-reduce of the gradient backward) on the replicated
input of a column-parallel Dense, and :class:`ReduceFromModel` (all-reduce
forward, identity backward) on the partial sums of a row-parallel Dense.
The layers (models/layers.py, models/clip_text.py) reach them only while
:func:`model_parallel` names a group and only where their kernels hold a
shard (core/partitioning.py); with no group they run as they did, with no
collective. ``ALL_REDUCES`` counts the forward all-reduces (chip_smoke
holds it to the count the code predicts) and ``REDUCED_BYTES`` their
bytes.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.distributed as dist

_GROUP: Optional[dist.ProcessGroup] = None
ALL_REDUCES = [0]
REDUCED_BYTES = [0]


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


def _all_reduce(x: torch.Tensor, grp) -> torch.Tensor:
    dist.all_reduce(x, group=grp)
    return x


class CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ctx.grp = grp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad.clone(), ctx.grp), None


class ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, grp):
        ALL_REDUCES[0] += 1
        REDUCED_BYTES[0] += x.numel() * x.element_size()
        return _all_reduce(x.clone(), grp)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    return CopyToModel.apply(x, _require())


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    return ReduceFromModel.apply(x, _require())


def _require() -> dist.ProcessGroup:
    if _GROUP is None:
        raise RuntimeError("a sharded Dense kernel outside model_parallel(): its partial "
                           "sums need the model group")
    return _GROUP
