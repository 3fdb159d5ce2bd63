"""The readings that set a cell's limits: the program's gaps to the plain
reference (the lower reading) and the control's (the upper).

    python3 -m portbench.control --workload <cell> --seeds 11,12,13 --units 6

For each seed, in one process on the card, against the plain fp32
reference's outputs: the program's, and the control's, the reference put
in the program's place with every product's operands rounded to float8
(``reference/edgestyle.py::Fp8Products``), the step below the
configuration's bf16. Generation cells also read the program's own int8
path (``quant="int8"``, W8A8 of the denoise step) and the gap that the
port's bf16 VAE decode alone leaves (``decode_only``); training cells a
planted fault, half of each micro-batch left out. With
``--int8-guarantee`` a generation cell reads only the int8 path's
precision guarantee (``int8_guarantee``). One JSON line per seed,
then each number's range. The benchmark's runs never run this; the limits
in ``limits/<cell>.json`` are set from its readings (``PERF.md``).
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import sys
from typing import Dict, List

import torch

from portbench.kinds.tryon import image_gaps
from portbench.run import load_cell


def decode_only(cell_run, refs: Dict, latents: Dict) -> Dict[str, float]:
    """The look at where the program's gap comes from: the port's bf16 VAE
    decode of the reference's own final latents, against the reference's
    image of them (the gap the decode alone leaves)."""
    from portbench.reference.edgestyle import VAE_SCALING

    out: Dict[str, float] = {}
    with torch.no_grad():
        for key, lat in latents.items():
            pipe = cell_run.pipe
            img = pipe.vae.decode(cell_run.params["vae"], lat.float() / VAE_SCALING)
            img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)[0].cpu()
            for k, v in image_gaps(img, refs[key]).items():
                out[k] = max(out.get(k, 0.0), v)
    return out


def half_batch(step_fn, mb: int):
    """A planted fault: each micro-batch's second half left out, the mean
    taken over the rest."""
    h = mb // 2

    def halve(d):
        return {k: (torch.cat([blk[:h] for blk in v.split(mb)]) if k == "cond_eps" else v[:h])
                for k, v in d.items()}

    return lambda state, frozen, batch, draws: step_fn(
        state, frozen, {k: v[:, :h] for k, v in batch.items()}, [halve(d) for d in draws])


def train_readings(cell: Dict, seed: int, device) -> Dict:
    """A training cell's readings on one seed: the program, the control
    (the reference with float8 products in its place) and the half-batch
    fault, each against the fp32 reference. A state left unchanged reads 1
    on ``change_gap`` by that number's measure and needs no run."""
    from portbench.kinds.train import Cell

    cell_run = Cell(cell["config"], cell["traffic"], seed, device)
    cell_run.setup()
    for i in range(cell_run.check_steps):
        cell_run.run_unit(i)
    cell_run.free()
    ref = cell_run.reference()
    fp8 = cell_run.as_program(cell_run.reference(fp8=True))
    out = {"seed": seed, "program": cell_run.gaps_to(ref),
           "control_fp8_reference": cell_run.gaps_to(ref, fp8)}
    import edgestyle_tpu_torch.training.train_step as ts

    fault = Cell(cell["config"], cell["traffic"], seed, device)
    orig = ts.make_train_step
    ts.make_train_step = lambda *a, **k: half_batch(orig(*a, **k), cell_run.mb)
    try:
        fault.setup(cell_run.weights)
        for i in range(fault.check_steps):
            fault.run_unit(i)
    finally:
        ts.make_train_step = orig
    fault.free()
    out["fault_half_batch"] = fault.gaps_to(ref)
    return out


def int8_guarantee(cell: Dict, seed: int, device) -> Dict:
    """The port's own int8 path (``quant="int8"``, W8A8 of the denoise
    step) as the control of a generation cell's precision guarantee: its
    ``low_precision_ops`` after a warm-up, and the operations counted."""
    from portbench.kinds.tryon import Cell

    cell_run = Cell(cell["config"], cell["traffic"], seed, device, quant="int8")
    cell_run.setup()
    held = cell_run.guarantees(0)
    out = {"seed": seed, "control_int8": held,
           "ops": sorted(cell_run.notes["low_precision_ops"].items())}
    cell_run.free()
    return out


def readings(cell: Dict, seed: int, units: int, device,
             variants=("none", "int8")) -> Dict:
    kind = importlib.import_module(f"portbench.kinds.{cell['traffic']['kind']}")
    out: Dict = {"seed": seed}
    keep = refs = None
    for quant in variants:
        cell_run = kind.Cell(cell["config"], cell["traffic"], seed, device, quant=quant)
        cell_run.setup(None if keep is None else keep.weights)
        pairs = cell_run.sample(units)
        for r in sorted({r for r, _ in pairs}):
            cell_run.run_unit(r)
        name = "program" if quant == "none" else f"control_{quant}"
        if keep is None:
            keep = cell_run
            out["pairs"] = pairs
            lat: Dict = {}
            refs = cell_run.reference_images(pairs, latents=lat)
            out["decode_only"] = decode_only(cell_run, refs, lat)
        cell_run.free()
        out[name] = cell_run.gaps_to(refs, stats=True)
        if keep is cell_run:
            own, cell_run.outputs = cell_run.outputs, {}
            for (r, j), im in cell_run.reference_images(pairs, fp8=True).items():
                cell_run.outputs.setdefault(r, {})[j] = im
            out["control_fp8_reference"] = cell_run.gaps_to(refs, stats=True)
            cell_run.outputs = own
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--units", type=int, required=True)
    p.add_argument("--int8-guarantee", action="store_true",
                   help="read only the int8 path's precision guarantee (generation cells)")
    args = p.parse_args(argv)
    cell = load_cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 2
    rows: List[Dict] = []
    for s in args.seeds.split(","):
        if args.int8_guarantee:
            r = int8_guarantee(cell, int(s), torch.device("cuda"))
        elif cell["traffic"]["kind"] == "train":
            r = train_readings(cell, int(s), torch.device("cuda"))
        else:
            r = readings(cell, int(s), args.units, torch.device("cuda"))
        print(json.dumps(r), flush=True)
        rows.append(r)
        gc.collect()
        torch.cuda.empty_cache()
    summary = {}
    for key in rows[0]:
        if isinstance(rows[0][key], dict):
            for m in rows[0][key]:
                vals = [r[key][m] for r in rows]
                summary[f"{key}.{m}"] = {"min": min(vals), "max": max(vals)}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
