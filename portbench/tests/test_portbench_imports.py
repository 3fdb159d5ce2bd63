"""What a run loads: no module whose top-level name, compared whole, is
jax, jaxlib, flax or the JAX package (``edgestyle_tpu``; the port's own
name begins with it). The reference loads nothing of the port either."""

import ast
import subprocess
import sys

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "edgestyle_tpu"}

RUN_TINY = """
import json, sys
from portbench import run
from portbench.tests.tiny import tiny_cell
rc = run.main(["--workload", "{name}", "--seed", "7", "--seconds", "0.1", "--trace", "1"],
              device="cpu", cell=tiny_cell("{name}"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600, check=True)
    return set(__import__("json").loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    name = __import__("json").loads((run.ROOT / "BENCHMARK.json").read_text())[
        "workloads"][0]["name"]
    mods = _top_modules(RUN_TINY.format(name=name))
    assert "edgestyle_tpu_torch" in mods and "portbench" in mods
    assert not mods & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    code = ("import json, sys\nimport portbench.reference.edgestyle, portbench.weights\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    mods = _top_modules(code)
    assert not mods & (FORBIDDEN | {"edgestyle_tpu_torch"})


def test_sources_import_no_jax():
    for path in sorted((run.BENCH_DIR).rglob("*.py")):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module:
                names.add(node.module.split(".")[0])
        assert not names & FORBIDDEN, path
        if "reference" in path.parts:
            assert "edgestyle_tpu_torch" not in names, path
