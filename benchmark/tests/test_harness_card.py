"""On the card (marker ``card``): one short run of each single-card cell
of ``BENCHMARK.json`` through the benchmark's command, and the control at the cells' own sizes
on three seeds, which has to fail a limit that the program keeps."""

import json
import subprocess
import sys

import pytest

from benchmark import check, cells
from benchmark.conftest import ROOT

SINGLE = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"] if w["chips"] == 1]


@pytest.mark.card
@pytest.mark.parametrize("workload", SINGLE)
def test_command_runs_on_the_card(workload, card):
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", workload, "--seed", "2147483713",
                          "--seconds", "5", "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=360)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("workload", SINGLE)
def test_control_fails_on_the_card(workload, card, tmp_path):
    path = tmp_path / "control.json"
    out = subprocess.run([sys.executable, "-m", "benchmark.control", "--workload", workload, "--seeds",
                          "11,12,13", "--control-seeds", "3", "--out", str(path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-2000:]
    limits = cells.load(workload, ROOT).limits
    for row in json.loads(path.read_text())["rows"]:
        assert row["correct"]
        assert not all(ok for _, _, _, ok in check.compare(row["control"], limits))
