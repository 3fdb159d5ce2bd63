"""The check says false when the timed path is broken underneath: the
harness's look for a chip is skipped (the CPU, a tiny size) and the rest of
a run is driven, once for each fault the cell can have. And the control,
the reference computed with float8 products in the program's place, reads
above one of each cell's limits while the program reads below them all;
the port's own int8 path fails a generation cell's precision guarantee."""

import json

import pytest
import torch

import edgestyle_tpu_torch.training.train_step as train_step
from edgestyle_tpu_torch.pipelines.tryon import EdgeStylePipeline
from edgestyle_tpu_torch.schedulers.lcm import LCMScheduler
from edgestyle_tpu_torch.schedulers.unipc import UniPCScheduler
from portbench import control, run
from portbench.tests.tiny import run_tiny, tiny_cell

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KIND = {n: run.load_cell(n)["traffic"]["kind"] for n in CELLS}
CALL = EdgeStylePipeline.__call__
MAKE_STEP = train_step.make_train_step


def state_unchanged(monkeypatch):
    """A denoise step that returns its state unchanged."""
    for cls in (UniPCScheduler, LCMScheduler):
        monkeypatch.setattr(cls, "step", lambda self, plan, i, out, sample, state, *a, **k:
                            (sample, state))


def half_batch(monkeypatch):
    """Half of the batch left out: the first half's rows stand for all."""
    def call(self, params, ids, neg, imgs, **kw):
        h = ids.shape[0] // 2
        kw["latents"] = kw["latents"][:h]
        if kw.get("lcm_noise") is not None:
            kw["lcm_noise"] = [n[:h] for n in kw["lcm_noise"]]
        out = CALL(self, params, ids[:h], neg[:h], [im[:h] for im in imgs], **kw)
        return torch.cat([out, out])
    monkeypatch.setattr(EdgeStylePipeline, "__call__", call)


def answer_altered(monkeypatch):
    """Each image altered where the pipeline produces it."""
    monkeypatch.setattr(EdgeStylePipeline, "__call__",
                        lambda self, *a, **k: (CALL(self, *a, **k) + 0.1).clamp(0, 1))


def rows_altered(monkeypatch):
    """The second half of each batch's images altered, the first half
    right (a fault of some rows, as in the CFG concat)."""
    def call(self, *a, **k):
        out = CALL(self, *a, **k)
        h = out.shape[0] // 2
        return torch.cat([out[:h], (out[h:] + 0.1).clamp(0, 1)])
    monkeypatch.setattr(EdgeStylePipeline, "__call__", call)


def int8_path(monkeypatch):
    """The port's own W8A8 int8 path switched on (a precision below the
    configuration's bf16)."""
    init = EdgeStylePipeline.__init__
    monkeypatch.setattr(EdgeStylePipeline, "__init__",
                        lambda self, *a, **k: init(self, *a, **{**k, "quant": "int8"}))


def step_unchanged(monkeypatch):
    """A training step that returns its state unchanged."""
    monkeypatch.setattr(train_step, "make_train_step", lambda *a, **k: (
        lambda state, frozen, batch, draws: (state, MAKE_STEP(*a, **k)(
            state, frozen, batch, draws)[1])))


def step_half_batch(monkeypatch):
    """Each micro-batch's second half left out, the mean taken over the
    rest."""
    mb = tiny_cell("train_mb8_ga8")["traffic"]["micro_batch"]
    monkeypatch.setattr(train_step, "make_train_step",
                        lambda *a, **k: control.half_batch(MAKE_STEP(*a, **k), mb))


FAULTS = {"tryon": [state_unchanged, half_batch, answer_altered, rows_altered, int8_path],
          "train": [step_unchanged, step_half_batch]}


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in FAULTS[KIND[n]]])
def test_fault_is_not_correct(name, fault, monkeypatch, capsys):
    fault(monkeypatch)
    res = run_tiny(name, capsys)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_a_limit(name):
    cell = tiny_cell(name)
    if KIND[name] == "train":
        r = control.train_readings(cell, 3_000_000_023, torch.device("cpu"))
    else:
        r = control.readings(cell, 3_000_000_023, 2, torch.device("cpu"), variants=("none",))
    limits = {k: v for k, v in cell["limits"].items() if k in r["program"]}
    assert limits
    assert all(r["program"][k] < v for k, v in limits.items())
    assert any(r["control_fp8_reference"][k] > v for k, v in limits.items())


@pytest.mark.parametrize("name", [n for n in CELLS if KIND[n] == "tryon"])
def test_int8_path_fails_the_precision_guarantee(name):
    cell = tiny_cell(name)
    r = control.int8_guarantee(cell, 3_000_000_023, torch.device("cpu"))
    assert r["control_int8"]["low_precision_ops"] > cell["limits"]["low_precision_ops"] == 0
    assert any(op.startswith("aten.") for op, _ in r["ops"])
