"""Nothing the harness runs loads JAX or the JAX package (top-level names
compared whole), and the reference imports nothing of the program."""

import ast
import subprocess
import sys

from benchmark import run
from benchmark.conftest import ROOT

CHILD = """
import sys
from benchmark import drive, run
from benchmark.conftest import any_cell, shrink
for w in ("dense8k-default-window", "dense8k-steepest-optimal"):
    cell = shrink(any_cell(w), 24, 64, 16, chunk=4, restart_after=16, sample_chunks=2, instances=2,
                  sample_steps_below=4, max_steps_per_solve=1000)
    run.run_cell(cell, 3, 0.1, True, "cpu", drive.Clock())
print("foreign=" + ",".join(run.foreign_modules()))
print("port=" + str("simplex_tpu_torch" in sys.modules))
"""


def test_a_run_loads_no_foreign_module():
    out = subprocess.run([sys.executable, "-c", CHILD], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    foreign, port = out.stdout.strip().splitlines()[-2:]
    assert foreign == "foreign=" and port == "port=True"


def test_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "simplex_tpu_torch_extra", sys)
    assert "simplex_tpu" not in run.foreign_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.foreign_modules() == ["jax"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark" / "reference").glob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] in ("__future__", "math", "torch", "benchmark"), (path, name)
            assert not name.startswith("benchmark.") or name.startswith("benchmark.reference"), (path, name)


def test_no_harness_file_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        for name in _imports(path):
            assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "simplex_tpu"), (path, name)
