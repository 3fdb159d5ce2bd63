"""Each cell of BENCHMARK.json parsed and run end to end at a tiny size
on the CPU, through the port's plain versions: the last line has the
contract's keys, the cell's metrics and the check beside its limit."""

import json

import pytest

from portbench import run
from portbench.tests.tiny import run_tiny, tiny_cell

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_parses(name):
    cell = run.load_cell(name)
    assert cell["end_to_end"] and cell["per_layer"]
    assert "setup_s" in {m["name"] for m in cell["end_to_end"]}
    moved = {m["name"] for m in cell["end_to_end"]}
    assert all(m["moves"] in moved for m in cell["per_layer"])
    for m in cell["per_layer"]:
        assert run.reader_path(m["name"]).is_file()
    assert set(cell["limits"]) and all(v >= 0 for v in cell["limits"].values())
    assert any(v > 0 for v in cell["limits"].values())


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_cell_runs_tiny(name, trace, capsys):
    res = run_tiny(name, capsys, trace=trace)
    assert list(res)[:3] == ["correct", "attempted", "failed"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] >= 1 and res["failed"] == 0
    cell = tiny_cell(name)
    if trace:
        # no device on the CPU: the trace's readers find nothing but the rate
        assert set(res["metrics"]) <= {m["name"] for m in cell["per_layer"]}
        assert {"busy_s", "window_s", "memory_peak_bytes"} <= set(res["device"])
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(res["metrics"]) == {m["name"] for m in cell["end_to_end"]}
        assert all(v["value"] > 0 for v in res["metrics"].values())
    for k, c in res["checks"].items():
        assert c["value"] <= c["limit"] == cell["limits"][k]


def test_reader_by_name_or_prefix():
    assert run.reader_path("flash_fwd_roofline").name == "flash_fwd_roofline.py"
    assert run.reader_path("idle_share.gen") == run.reader_path("idle_share.train")
    assert run.reader_path("idle_share.gen").name == "idle_share.py"


@pytest.mark.parametrize("name", [n for n in CELLS if run.load_cell(n)["traffic"]["kind"] == "tryon"])
def test_sample_takes_a_row_from_each_part_of_the_batch(name):
    from portbench.kinds.tryon import Cell

    cell = run.load_cell(name)
    b, k = cell["traffic"]["batch"], cell["traffic"]["check_images"]
    for seed in (1, 3_000_000_019, 2 ** 31 + 11):
        for n_units in (1, 2, 7):
            pairs = Cell(cell["config"], cell["traffic"], seed, None).sample(n_units)
            assert len(set(pairs)) == k and all(0 <= r < n_units for r, _ in pairs)
            assert sorted(j * k // b for _, j in pairs) == list(range(k))


def test_unknown_workload_exits():
    with pytest.raises(SystemExit):
        run.load_cell("no_such_cell")
