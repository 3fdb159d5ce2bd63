"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``portbench/``
and the port, ``edgestyle_tpu_torch``, on a machine with as many CUDA cards
as the cell asks for. Everything the cell needs is found by name:
``BENCHMARK.json`` names the cell's configuration (its file under
``portbench/configs/``) and traffic mix (``portbench/traffic/<mix>.json``,
whose ``kind`` picks the module ``portbench/kinds/<kind>.py``); the limits
of its check are ``portbench/limits/<cell>.json``; each per-layer metric is
read by ``portbench/metrics/<metric>.py``, or, where there is no such
file, by the reader of the part of its name before the first dot (one
reader serves ``idle_share.gen`` and ``idle_share.train``).

A run: set-up (weights made on the card from the seed, the port built from
them through its own converters, one warm-up unit at the cell's shapes),
then whole units back to back until ``--seconds`` have passed; the rate is
the work of every unit over the time from the window's start to the end of
the last unit (at least ``min_units`` of them: the training check follows
the window's first steps). With ``--trace 1`` a few more units run under
``torch.profiler`` after the window, and the per-layer metrics are read
from them. Then the program's state is freed and the plain reference
checks a sample of the window's outputs, beside the cell's guarantees
(``guarantees``: the program, run once more, holds the configuration's
precision). The last line of standard output
is the result as one JSON object; the numbers compared, with their limits,
are also the last lines of standard error.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
BENCH_DIR = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "edgestyle_tpu")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_cell(name: str, bench: Optional[Dict] = None) -> Dict:
    """The cell ``name`` with its configuration, traffic mix, limits and
    metrics, as ``BENCHMARK.json`` and the files it names give them."""
    if bench is None:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    wl = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    cfg = json.loads((ROOT / cfg_entry["file"]).read_text())
    traffic = json.loads((BENCH_DIR / "traffic" / f"{wl['traffic']}.json").read_text())
    limits = json.loads((BENCH_DIR / "limits" / f"{name}.json").read_text())

    def applies(m: Dict) -> bool:
        return name in m["workloads"] if "workloads" in m else True

    return {"workload": wl, "config": cfg, "traffic": traffic, "limits": limits,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def reader_path(name: str) -> Path:
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``,
    else ``metrics/<name up to its first dot>.py``."""
    own = BENCH_DIR / "metrics" / f"{name}.py"
    return own if own.is_file() else BENCH_DIR / "metrics" / f"{name.split('.')[0]}.py"


def read_metric(name: str, run: Dict) -> Optional[float]:
    """The metric's reader's ``read(run)``: a number, or None where the
    trace holds nothing for it."""
    path = reader_path(name)
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def power_limit() -> Optional[str]:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def traced(runner, first: int, count: int, sync) -> Dict:
    """Run ``count`` units under a device-only trace, then ``count`` more
    under a trace of host operators with shapes; the reduced traces."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from portbench import trace

    items = 0
    # a CPU run (the tests') has no device activity to trace
    with (profile(activities=[ProfilerActivity.CUDA]) if torch.cuda.is_available()
          else contextlib.nullcontext()) as prof:
        for i in range(first, first + count):
            items += runner.run_unit(i)
        sync()
    out = trace.device_summary(prof.profiler.kineto_results.events() if prof else [])
    out["items"] = items
    del prof
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with record_function(trace.MARK):
            for i in range(first + count, first + 2 * count):
                runner.run_unit(i)
            sync()
    events = prof.profiler.kineto_results.events()
    mark = [e for e in events if e.name() == trace.MARK
            and e.device_type() == torch.autograd.DeviceType.CPU]
    if not mark:
        raise RuntimeError("the profiler recorded no traced section")
    out.update(trace.host_summary(events, mark[0].start_ns(), mark[0].end_ns()))
    del prof, events
    return out


def main(argv=None, device=None, cell: Optional[Dict] = None) -> int:
    """``device``: None for the card (the benchmark); a test passes "cpu"
    and a ``cell`` of its own (the plain versions at a tiny size)."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if cell is None:
        cell = load_cell(args.workload)
    wl = cell["workload"]

    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
            print(f"portbench: the cell needs {wl['chips']} CUDA card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = "cuda"
        # the deployment's host setting, stated in the configuration's file
        torch.set_num_threads(cell["config"]["host_threads"])
        build = ROOT / "build"
        # every build and kernel cache at a fixed path inside the checkout
        os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
        os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    kind = importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    runner = kind.Cell(cell["config"], cell["traffic"], args.seed, dev)
    runner.setup()
    sync()
    setup_s = time.perf_counter() - T_PROCESS

    units = items = 0
    min_units = getattr(runner, "min_units", 1)
    t0 = t_end = time.perf_counter()
    unit_s = []
    while True:
        items += runner.run_unit(units)
        units += 1
        t_prev, t_end = t_end, time.perf_counter()
        unit_s.append(t_end - t_prev)
        if t_end - t0 >= args.seconds and units >= min_units:
            break
    rate = items / (t_end - t0)

    run: Dict = {"rate": rate, "units": units, "items": items}
    if args.trace:
        run["trace"] = traced(runner, units, cell["traffic"]["trace_units"], sync)
        units += 2 * cell["traffic"]["trace_units"]
        run["flops_per_item"] = runner.model_flops_per_item()
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    held = runner.guarantees(units) if hasattr(runner, "guarantees") else {}
    runner.free()
    gaps = {**held, **runner.gaps(units)}
    checks = {k: {"value": v, "limit": cell["limits"][k]} for k, v in gaps.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())

    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3

    result: Dict = {"correct": correct, "attempted": units, "failed": 0}
    if args.trace:
        tr = run["trace"]
        metrics = {}
        for m in cell["per_layer"]:
            v = read_metric(m["name"], run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        values = {"setup_s": setup_s, runner.rate_metric: rate}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell["end_to_end"]}
    result["device"] = {"platform": "gpu" if on_card else dev.type,
                        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                        "count": wl["chips"], "memory_peak_bytes": peak}
    if args.trace:
        result["device"].update(busy_s=tr["busy_s"], window_s=tr["window_s"])
        result["breakdown"] = {"device_ops": tr["device_ops"], "idle_gaps": tr["idle_gaps"]}
    result["power_limit"] = power_limit() if on_card else None
    result["checks"] = checks
    sys.stdout.flush()
    print(f"setup parts: {getattr(runner, 'setup_parts', {})}", file=sys.stderr)
    print(f"window unit seconds: {unit_s}", file=sys.stderr)
    if getattr(runner, "notes", None):
        print(f"check notes: {runner.notes}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
