"""The port's five kernel launches as operators of one ``torch.library``
namespace, ``edgestyle``.

An operator is what a graph capture sees: ``torch.export`` (core/export.py)
traces a call of one as a single node, through its fake implementation,
which gives the outputs' shapes, types and strides from the inputs' alone,
and a reloaded graph calls the operator's CUDA implementation, the
ctypes wrapper that launches the kernel and counts the launch
(``kernels.LAUNCHES``). ops/flash.py and ops/fused_conv.py define the five
and call them on CUDA tensors; a CPU tensor never reaches one, since their
autograd Functions take the plain versions there, so an operator has a
CUDA implementation and no CPU one.

The operators are defined with ``Library.define`` and ``Library.impl``
rather than ``torch.library.custom_op``, whose Python layer costs several
times more host time a call (``PERF.md`` gives both on the card's host);
a B=1 generation makes 4,696 of these calls. No operator declares a
mutated argument: the GN statistics' per-device counters and the
workspaces are the implementation's own.

Each operator also has a FLOP formula for ``FlopCounterMode``
(``core/export.py::flop_report``): 4 N^2 D a head for the attention
forward, 6 N^2 D for dq, 8 N^2 D for dk and dv, 2 B H W Cin Cout 9 for the
conv, 0 for the GroupNorm statistics.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch.utils.flop_counter import register_flop_formula

NAMESPACE = "edgestyle"
LIB = torch.library.Library(NAMESPACE, "DEF")


def define(name: str, schema: str, cuda: Callable, fake: Callable, flops: Callable):
    """Define ``edgestyle::<name><schema>`` with its CUDA and fake
    implementations and FLOP formula (called with the arguments' shapes);
    returns the operator's one overload."""
    LIB.define(name + schema)
    LIB.impl(name, cuda, "CUDA")
    torch.library.register_fake(f"{NAMESPACE}::{name}", fake, lib=LIB)
    op = getattr(getattr(torch.ops, NAMESPACE), name)
    register_flop_formula(op)(flops)
    return op.default
