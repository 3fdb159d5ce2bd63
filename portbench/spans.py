"""The port's spans in a traced section, reduced to numbers an item.

    python3 -m portbench.spans --workload <cell> --seed <n> [--units <k>]

sets a cell of ``BENCHMARK.json`` up as ``portbench.run`` does, runs one
unit untraced, then ``k`` units (the traffic's ``trace_units`` by default)
under the trace that ``run.py``'s second traced section takes (host
operators with their shapes, and the device), and prints the span table as
one JSON object on the last line of standard output.

The port opens an operator range named ``edgestyle/...`` at each layer
boundary while a profiler runs (edgestyle_tpu_torch/core/spans.py lists
them), in the same trace and on the same clock as the device's activity.
The ranges are operators, not user annotations, so kineto makes no device
copy of them and ``trace.py``'s reductions read the same device work with
them as without. For each name, over the section's ``items`` (images or
samples):

- ``calls``: its instances an item;
- ``host_ms``: the host time inside an instance, and ``self_ms``, the part
  of it in which no other span was opened inside it;
- ``device_ms``: the time of the device operations (kernels, copies, sets)
  whose launching host operator (``linked_correlation_id``) started inside
  an instance, counted in every span open then (inclusive). By time, on any
  thread: the autograd engine launches a backward from its own thread while
  the caller waits inside ``edgestyle/train.backward``;
- ``idle_ms``: the device's idle gaps (as ``trace.host_summary`` finds
  them), each given to the innermost span open when the operation that
  ended it was launched.

``outside`` holds the device and idle time launched in no span (the gap
after the section's last operation too), ``unattributed`` that of
operations with no host operator in the trace, and ``total`` the section's
wall, device and idle time an item. Device and idle numbers are None where
the section has no device operation (a CPU run). A program without spans
gives ``outside`` and ``total`` alone.
"""

from __future__ import annotations

import argparse
import bisect
import importlib
import json
import os
import sys
from collections import defaultdict
from typing import Dict, List, Optional

from portbench.trace import MARK, RUNTIME

SPANS = "edgestyle/"

MS = 1e-6  # ns -> ms


def _timeline(inst: List):
    """The instances' boundaries and, for each interval between two of them,
    the names of the spans open there and the innermost one (the latest
    start, then the earliest end)."""
    bounds = sorted({t for s, e, _ in inst for t in (s, e)})
    segs = []
    for b in bounds[:-1]:
        open_ = [(s, -e, n) for s, e, n in inst if s <= b < e]
        segs.append((frozenset(n for *_, n in open_), max(open_)[2] if open_ else None))
    return bounds, segs


def summary(events, t0_ns: int, t1_ns: int, items: int) -> Dict[str, Dict]:
    from torch.autograd import DeviceType

    inst, launch, dev = [], {}, []
    for e in events:
        name, kind = e.name(), e.device_type()
        if name == MARK or name.startswith("ProfilerStep"):
            continue
        if kind == DeviceType.CPU and not name.startswith(RUNTIME):
            launch[e.correlation_id()] = e.start_ns()
            if name.startswith(SPANS):
                s, t = max(e.start_ns(), t0_ns), min(e.end_ns(), t1_ns)
                if t > s:
                    inst.append((s, t, name))
        elif kind == DeviceType.CUDA:
            s, t = max(e.start_ns(), t0_ns), min(e.end_ns(), t1_ns)
            if t > s:
                dev.append((s, t, e.linked_correlation_id()))
    dev = [(s, t, launch.get(c) if c else None) for s, t, c in dev]
    bounds, segs = _timeline(inst)

    def at(t: Optional[int]):
        """(names open, innermost) at host time ``t``."""
        if t is None:
            return None, "unattributed"
        i = bisect.bisect_right(bounds, t) - 1
        if 0 <= i < len(segs) and segs[i][1] is not None:
            return segs[i]
        return frozenset(), "outside"

    calls: Dict[str, int] = defaultdict(int)
    host: Dict[str, int] = defaultdict(int)
    own: Dict[str, int] = defaultdict(int)
    for _, _, n in inst:
        calls[n] += 1
    for (names, inner), a, b in zip(segs, bounds, bounds[1:]):
        for n in names:
            host[n] += b - a
        if inner is not None:
            own[inner] += b - a
    device: Dict[str, int] = defaultdict(int)
    idle: Dict[str, int] = defaultdict(int)
    end = t0_ns
    for s, t, lt in sorted(dev):
        names, inner = at(lt)
        for n in names or (inner,):
            device[n] += t - s
        if s > end:
            idle[inner] += s - end
        end = max(end, t)
    if dev and t1_ns > end:
        idle["outside"] += t1_ns - end

    def per_item(v: Optional[int]) -> Optional[float]:
        return None if v is None or not dev else v * MS / items

    out: Dict[str, Dict] = {}
    for n in sorted(calls):
        out[n] = {"calls": calls[n] / items, "host_ms": host[n] * MS / items,
                  "self_ms": own[n] * MS / items, "device_ms": per_item(device[n]),
                  "idle_ms": per_item(idle[n])}
    out["outside"] = {"device_ms": per_item(device["outside"]),
                      "idle_ms": per_item(idle["outside"])}
    if device["unattributed"] or idle["unattributed"]:
        out["unattributed"] = {"device_ms": per_item(device["unattributed"]),
                               "idle_ms": per_item(idle["unattributed"])}
    out["total"] = {"wall_ms": (t1_ns - t0_ns) * MS / items,
                    "device_ms": per_item(sum(t - s for s, t, _ in dev)),
                    "idle_ms": per_item(sum(idle.values()))}
    return out


def traced(runner, first: int, count: int, sync) -> Dict[str, Dict]:
    """Run ``count`` units from ``first`` under a trace of host operators
    with shapes and of the device; their span table."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    items = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with record_function(MARK):
            for i in range(first, first + count):
                items += runner.run_unit(i)
            sync()
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == MARK
            and e.device_type() == torch.autograd.DeviceType.CPU]
    if not mark:
        raise RuntimeError("the profiler recorded no traced section")
    return summary(events, mark[0].start_ns(), mark[0].end_ns(), items)


def main(argv=None, device=None, cell: Optional[Dict] = None) -> int:
    """``device``: None for the card; a test passes "cpu" and a ``cell`` of
    its own, as to ``portbench.run.main``."""
    from portbench import run

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--units", type=int, default=None,
                   help="units traced (default: the traffic's trace_units)")
    args = p.parse_args(argv)
    if cell is None:
        cell = run.load_cell(args.workload)

    import torch

    if device is None:
        chips = cell["workload"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"portbench: the cell needs {chips} CUDA card(s)", file=sys.stderr)
            return 2
        device = "cuda"
        torch.set_num_threads(cell["config"]["host_threads"])
        build = run.ROOT / "build"
        os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
        os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kind = importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    runner = kind.Cell(cell["config"], cell["traffic"], args.seed, torch.device(device))
    runner.setup()
    runner.run_unit(0)
    sync()
    table = traced(runner, 1, args.units or cell["traffic"]["trace_units"], sync)
    runner.free()
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
