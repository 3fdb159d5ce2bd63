"""On a CUDA card: one short run of each cell through the command the
benchmark gives, correct and with its metrics. Skips without a card."""

import json
import subprocess
import sys

import pytest

from portbench import run

BENCH = json.loads((run.ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels have no CPU mode")


@pytest.mark.gpu
@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_on_card(card, name):
    out = subprocess.run([sys.executable, *BENCH["command"][1:], "--workload", name,
                          "--seed", "3000000029", "--seconds", "5", "--trace", "0"],
                         cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
    assert set(res["metrics"]) == {m["name"] for m in run.load_cell(name)["end_to_end"]}


def test_no_card_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", BENCH["workloads"][0]["name"], "--seed", "1",
                     "--seconds", "1"]) != 0
    assert capsys.readouterr().out == ""
