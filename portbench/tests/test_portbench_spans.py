"""The port's spans in the trace (portbench/spans.py) on hand-made profiler
events: the existing reductions untouched by the ranges, device time
inclusive and by time on any thread, each idle gap to the innermost span;
and the span table of a tiny cell on the CPU."""

import json

import pytest
from pytest import approx

from portbench import spans, trace
from portbench.tests.test_portbench_cells import CELLS
from portbench.tests.test_portbench_trace import CPU, CUDA, Ev
from portbench.tests.tiny import tiny_cell

GEN, MCN, FUSION = "edgestyle/gen", "edgestyle/mcn", "edgestyle/mcn.fusion"
BACKWARD = "edgestyle/train.backward"


def parent_events():
    """tests/test_portbench_trace.py::test_reduce's trace: no span."""
    return [
        Ev(trace.MARK, CPU, 0, 1000),
        Ev(trace.MARK, CUDA, 0, 1000),
        Ev("edgestyle::flash_fwd", CPU, 100, 200, corr=1, shapes=[[1, 1, 4, 4]],
           dtypes=["c10::BFloat16"]),
        Ev("aten::empty_like", CPU, 110, 120, corr=2),
        Ev("aten::mul", CPU, 300, 320, corr=3),
        Ev("cudaLaunchKernel", CPU, 150, 160, corr=9),
        Ev("flash_fwd_kernel", CUDA, 200, 400, linked=1),
        Ev("fill_kernel", CUDA, 350, 450, linked=2),
        Ev("Memcpy DtoH", CUDA, 600, 700, linked=3),
        Ev("mul_kernel", CUDA, 800, 900, linked=3),
    ]


def with_ranges(events):
    """``events`` inside a gen span and an mcn span: operator ranges on the
    host, with no device copy."""
    return events + [Ev(GEN, CPU, 50, 950, corr=20), Ev(MCN, CPU, 90, 330, corr=21)]


def test_ranges_leave_the_existing_reductions_as_they_were():
    before = parent_events()
    dev, host = trace.device_summary(before), trace.host_summary(before, 0, 1000)
    # test_reduce's numbers: the reductions as they were before the ranges
    assert dev["busy_s"] == approx(450e-9) and dev["kernels"] == 3
    assert dict(host["idle_gaps"]) == approx({"edgestyle::flash_fwd": 200e-9,
                                              "aten::mul": 250e-9,
                                              "after the last operation": 100e-9})
    assert trace.device_summary(with_ranges(before)) == dev
    assert trace.host_summary(with_ranges(before), 0, 1000) == host
    # a parent's trace has no span: its table is the section's alone
    tab = spans.summary(before, 0, 1000, items=2)
    assert set(tab) == {"outside", "total"}
    assert tab["total"] == approx({"wall_ms": 500e-6, "device_ms": 250e-6, "idle_ms": 275e-6})
    assert tab["outside"] == approx({"device_ms": 250e-6, "idle_ms": 275e-6})


def test_device_time_is_inclusive_over_nested_spans():
    events = [
        Ev(GEN, CPU, 0, 1000, corr=10), Ev(MCN, CPU, 100, 400, corr=11),
        Ev(FUSION, CPU, 300, 400, corr=12),
        Ev("aten::a", CPU, 150, 160, corr=1), Ev("aten::b", CPU, 350, 360, corr=2),
        Ev("aten::c", CPU, 600, 610, corr=3), Ev("aten::d", CPU, 1100, 1110, corr=4),
        Ev("ka", CUDA, 200, 230, linked=1), Ev("kb", CUDA, 400, 450, linked=2),
        Ev("kc", CUDA, 700, 770, linked=3), Ev("kd", CUDA, 1200, 1300, linked=4),
    ]
    tab = spans.summary(events, 0, 2000, items=2)
    assert tab[FUSION]["device_ms"] == approx(50e-6 / 2)
    assert tab[MCN]["device_ms"] == approx(80e-6 / 2)
    assert tab[GEN]["device_ms"] == approx(150e-6 / 2)
    assert tab["outside"]["device_ms"] == approx(100e-6 / 2)
    assert tab["total"]["device_ms"] == approx(250e-6 / 2)
    assert tab[GEN]["calls"] == 0.5 and tab[MCN]["calls"] == 0.5
    assert tab[GEN]["host_ms"] == approx(1000e-6 / 2)
    assert tab[GEN]["self_ms"] == approx(700e-6 / 2)  # less mcn's 300
    assert tab[MCN]["self_ms"] == approx(200e-6 / 2)  # less fusion's 100


def test_a_kernel_launched_from_another_thread_counts_to_the_open_span():
    events = [
        Ev("edgestyle/train.step", CPU, 0, 1000, corr=10, tid=1),
        Ev(BACKWARD, CPU, 100, 500, corr=11, tid=1),
        Ev("aten::mm", CPU, 200, 210, corr=1, tid=2),  # the autograd engine's thread
        Ev("aten::mm", CPU, 600, 610, corr=2, tid=2),
        Ev("mm_kernel", CUDA, 300, 400, linked=1), Ev("mm_kernel", CUDA, 700, 720, linked=2),
        Ev("orphan", CUDA, 800, 810, linked=99),  # no host operator in the trace
    ]
    tab = spans.summary(events, 0, 1000, items=1)
    assert tab[BACKWARD]["device_ms"] == approx(100e-6)
    assert tab["edgestyle/train.step"]["device_ms"] == approx(120e-6)
    assert tab["unattributed"]["device_ms"] == approx(10e-6)


def test_each_idle_gap_goes_to_the_innermost_span():
    events = [
        Ev(GEN, CPU, 0, 1000, corr=10), Ev(MCN, CPU, 100, 400, corr=11),
        Ev(FUSION, CPU, 300, 400, corr=12),
        Ev("aten::a", CPU, 150, 160, corr=1), Ev("aten::b", CPU, 350, 360, corr=2),
        Ev("aten::c", CPU, 600, 610, corr=3),
        Ev("ka", CUDA, 200, 250, linked=1), Ev("kb", CUDA, 400, 450, linked=2),
        Ev("kc", CUDA, 700, 800, linked=3),
    ]
    tab = spans.summary(events, 0, 1000, items=1)
    assert tab[MCN]["idle_ms"] == approx(200e-6)  # 0..200, ended by ka
    assert tab[FUSION]["idle_ms"] == approx(150e-6)  # 250..400, ended by kb
    assert tab[GEN]["idle_ms"] == approx(250e-6)  # 450..700, ended by kc
    assert tab["outside"]["idle_ms"] == approx(200e-6)  # after the last operation
    idle = sum(v["idle_ms"] for k, v in tab.items() if k != "total")
    assert idle == approx(tab["total"]["idle_ms"]) == approx(800e-6)
    host = trace.host_summary(events, 0, 1000)
    assert sum(v for _, v in host["idle_gaps"]) * 1e3 == approx(tab["total"]["idle_ms"])


@pytest.mark.parametrize("name", CELLS)
def test_span_table_of_a_tiny_cell_on_the_cpu(name, capsys):
    """The CLI on a tiny cell: the root span holds the traced work, once a
    unit; host ms read above zero; device and idle ms find no device."""
    cell = tiny_cell(name)
    assert spans.main(["--workload", name, "--seed", "3000000019"], device="cpu", cell=cell) == 0
    tab = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    train = cell["traffic"]["kind"] == "train"
    root = "edgestyle/train.step" if train else GEN
    per_unit = 1 / (cell["traffic"]["micro_batch"] * cell["traffic"]["grad_accum"] if train
                    else cell["traffic"]["batch"])
    assert tab[root]["calls"] == approx(per_unit)
    assert 0 < tab[root]["host_ms"] <= tab["total"]["wall_ms"]
    named = [n for n in tab if n.startswith("edgestyle/")]
    assert {"edgestyle/mcn", "edgestyle/unet", "edgestyle/vae.encode"} <= set(named)
    if train:
        assert {"edgestyle/train.optimizer", "edgestyle/train.accumulate",
                "edgestyle/train.merge_lora", "edgestyle/train.backward"} <= set(named)
    for n in named:
        assert tab[n]["host_ms"] > 0
        assert tab[n]["device_ms"] is None and tab[n]["idle_ms"] is None
