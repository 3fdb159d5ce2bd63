"""Peaks of the chip and the operations and bytes of the port's kernels.

Frozen copies of the arithmetic, so that a change to the program cannot
move them. Peaks: one NVIDIA H100 SXM's data sheet, dense, at its full
700 W limit: 989 TFLOP/s bf16, 3.35 TB/s HBM3. The FLOP formulas are the
port's operator formulas (``ops/library.py``): attention forward 4 N Nk D a
head, dq 6, dk and dv 8; the 3x3 conv 2 B H W Cin Cout 9; the GroupNorm
statistics none. Bytes: each input read once and each output written once,
from the shapes and types the profiler recorded for the call.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12

DTYPE_BYTES = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8,
               "long int": 8, "int": 4, "signed char": 1, "unsigned char": 1}


def _n(shape: Sequence[int]) -> int:
    return math.prod(shape) if shape else 1


def _in_bytes(shapes, dtypes) -> int:
    return sum(_n(s) * DTYPE_BYTES.get(d, 0) for s, d in zip(shapes, dtypes)
               if isinstance(s, (list, tuple)) and len(s))


def flash_fwd(shapes, dtypes):
    (b, h, n, d), (_, _, nk, _) = shapes[0], shapes[1]
    out = _n(shapes[0]) * DTYPE_BYTES[dtypes[0]] + b * h * n * 4  # O and the fp32 lse
    return 4 * b * h * n * nk * d, _in_bytes(shapes, dtypes) + out


def flash_bwd_dq(shapes, dtypes):
    (b, h, n, d), (_, _, nk, _) = shapes[0], shapes[1]
    return 6 * b * h * n * nk * d, _in_bytes(shapes, dtypes) + _n(shapes[0]) * DTYPE_BYTES[
        dtypes[0]]


def flash_bwd_dkv(shapes, dtypes):
    (b, h, n, d), (_, _, nk, _) = shapes[0], shapes[1]
    out = 2 * _n(shapes[1]) * DTYPE_BYTES[dtypes[1]]
    return 8 * b * h * n * nk * d, _in_bytes(shapes, dtypes) + out


def gn_scale_shift(shapes, dtypes):
    b, c = shapes[0][:2]
    return 0, _in_bytes(shapes[:3], dtypes[:3]) + 2 * b * c * 4


def fused_gn_silu_conv3x3(shapes, dtypes):
    b, cin, h, w = shapes[0]
    cout = shapes[3][0]
    return 2 * b * h * w * cin * cout * 9, _in_bytes(shapes, dtypes) + b * cout * h * w * 2


FORMULAS = {"edgestyle::flash_fwd": flash_fwd, "edgestyle::flash_bwd_dq": flash_bwd_dq,
            "edgestyle::flash_bwd_dkv": flash_bwd_dkv,
            "edgestyle::gn_scale_shift": gn_scale_shift,
            "edgestyle::fused_gn_silu_conv3x3": fused_gn_silu_conv3x3}


def bound_s(op: str, shapes, dtypes) -> float:
    """The least time the chip could take for one call."""
    flops, nbytes = FORMULAS[op](shapes, dtypes)
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def roofline_pct(calls: Dict[str, List[Dict]], ops: Sequence[str]) -> Optional[float]:
    """100 x the sum of the calls' bounds over the sum of their device
    times, for the operators ``ops``; None when the trace holds no call of
    them or no device time."""
    bound = dev = 0.0
    for op in ops:
        for c in calls.get(op, ()):
            bound += bound_s(op, c["shapes"], c["dtypes"])
            dev += c["device_s"]
    if not dev or not bound:
        return None
    return 100.0 * bound / dev


def counted_flops(fn, *args, **kwargs) -> int:
    """The FLOPs of ``fn(*args, **kwargs)`` as ``FlopCounterMode`` counts
    them: matrix products and convolutions, 2 per multiply-add. Run it on
    meta tensors and it costs no compute."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return counter.get_total_flops()
