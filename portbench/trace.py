"""The traced section of a run, reduced to the numbers the per-layer
metrics read.

Two traces of a few whole units each follow the measured window, both
reduced here in memory (nothing is written to disk). The first records
device activity alone, so the profiler barely slows the host, and gives
the device's busy time (the union of the intervals of every device
operation: kernels, copies, sets), the window, the kernels launched and the
device operations that took most time. The second also records the host's
operators with their shapes (slower: its idle share would read high), and
gives each port operator's calls, shapes and correlated device time, and
the idle gaps named by what the host was doing.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List

PORT_OPS = ("edgestyle::flash_fwd", "edgestyle::flash_bwd_dq", "edgestyle::flash_bwd_dkv",
            "edgestyle::gn_scale_shift", "edgestyle::fused_gn_silu_conv3x3")
TOP = 10
MARK = "portbench.traced_units"
# CUDA runtime calls (cuda*, cu*): host events, not operators
RUNTIME = ("cuda", "cuLaunch", "cuMem", "cuStream", "cuEvent", "cuCtx", "cuModule", "cuGraph")


def _union(intervals: List) -> float:
    total, end = 0, None
    start = None
    for s, e in sorted(intervals):
        if end is None or s > end:
            if end is not None:
                total += end - start
            start, end = s, e
        else:
            end = max(end, e)
    if end is not None:
        total += end - start
    return total


def device_summary(events) -> Dict:
    """A trace of device activity alone (the host's operators untraced, so
    the profiler barely slows the host): the window from the first device
    operation's start to the last one's end, the union of the operations'
    intervals, the kernels launched, and the operations that took most
    time."""
    from torch.autograd import DeviceType

    spans, kernels = [], 0
    by_name: Dict[str, int] = defaultdict(int)
    for e in events:
        if e.device_type() != DeviceType.CUDA or e.name() == MARK:
            continue
        s, t = e.start_ns(), e.end_ns()
        spans.append((s, t))
        name = e.name()
        if not name.startswith(("Memcpy", "Memset", "memcpy", "memset")):
            kernels += 1
        by_name[name[:120]] += t - s
    if not spans:
        return {"window_s": 0.0, "busy_s": 0.0, "kernels": 0, "device_ops": []}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (max(t for _, t in spans) - min(s for s, _ in spans)) * 1e-9,
            "busy_s": _union(spans) * 1e-9, "kernels": kernels,
            "device_ops": [[n, v * 1e-9] for n, v in top]}


def host_summary(events, t0_ns: int, t1_ns: int) -> Dict:
    """A trace of host operators with their shapes and of the device,
    within ``t0_ns``..``t1_ns``: each port operator's calls with their
    input shapes and types and the device time of the kernels correlated to
    the call or to an operator nested in it; the idle gaps, each named by
    the host operator that launched the kernel which ends it."""
    from torch.autograd import DeviceType

    dev, cpu = [], []
    for e in events:
        name = e.name()
        if name == MARK or name.startswith("ProfilerStep"):
            continue  # the traced section's own range, on the host and the device
        kind = e.device_type()
        if kind == DeviceType.CUDA:
            dev.append(e)
        elif kind == DeviceType.CPU and not name.startswith(RUNTIME):
            cpu.append(e)
    spans = []
    linked: Dict[int, List] = defaultdict(list)
    for e in dev:
        s, t = max(e.start_ns(), t0_ns), min(e.end_ns(), t1_ns)
        if t <= s:
            continue
        spans.append((s, t, e.linked_correlation_id()))
        linked[e.linked_correlation_id()].append(t - s)

    cpu.sort(key=lambda e: e.start_ns())
    starts = [e.start_ns() for e in cpu]
    by_corr = {e.correlation_id(): e for e in cpu}
    ops: Dict[str, List] = defaultdict(list)
    for op in cpu:
        name = op.name()
        if name not in PORT_OPS:
            continue
        lo = bisect.bisect_left(starts, op.start_ns())
        hi = bisect.bisect_right(starts, op.end_ns())
        tid = op.start_thread_id()
        dev_ns = 0
        for inner in cpu[lo:hi]:
            if inner.start_thread_id() == tid and inner.end_ns() <= op.end_ns():
                dev_ns += sum(linked.get(inner.correlation_id(), ()))
        ops[name].append({"shapes": op.shapes(), "dtypes": op.dtypes(), "device_s": dev_ns * 1e-9})

    gaps: Dict[str, int] = defaultdict(int)
    spans.sort()
    end = t0_ns
    for s, t, corr in spans:
        if s > end:
            host = by_corr.get(corr)
            gaps[host.name() if host is not None else "unattributed"] += s - end
        end = max(end, t)
    if t1_ns > end:
        gaps["after the last operation"] += t1_ns - end
    top_gaps = sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]
    return {"ops": dict(ops), "idle_gaps": [[n, v * 1e-9] for n, v in top_gaps]}
