"""The benchmark's cells at a size a CPU test can hold: the same files and
code, the widths and depths cut, fp32 (the port's plain versions)."""

import copy
import json
import sys

from portbench import run


def tiny_cell(name: str) -> dict:
    cell = copy.deepcopy(run.load_cell(name))
    cfg, traffic = cell["config"], cell["traffic"]
    cfg.update(sample_size=64, dtype="float32", controllora_rank=4)
    cfg["unet"].update(block_out_channels=[32, 64], layers_per_block=1, num_heads=2,
                       cross_attention_dim=32, cond_embedding_channels=[16, 32])
    cfg["vae"].update(block_out_channels=[32, 32], layers_per_block=1)
    cfg["clip"].update(hidden_size=32, num_layers=2, num_heads=2, intermediate_size=64)
    if traffic["kind"] == "train":
        traffic.update(micro_batch=2, grad_accum=2, trace_units=1)
    else:
        traffic.update(batch=2, steps=min(traffic["steps"], 3), check_images=2, trace_units=1)
    if traffic.get("lcm_lora_rank"):
        traffic["lcm_lora_rank"] = 4
    return cell


def run_tiny(name: str, capsys, seed: int = 3_000_000_019, trace: int = 0,
             cell: dict = None) -> dict:
    """One run of the cell at the tiny size on the CPU; the last line of
    its standard output, parsed."""
    rc = run.main(["--workload", name, "--seed", str(seed), "--seconds", "0.2",
                   "--trace", str(trace)], device="cpu", cell=cell or tiny_cell(name))
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    sys.stdout.write("\n".join(out[:-1]))
    return json.loads(out[-1])
