"""Every cell of BENCHMARK.json finds its files by name, the file keeps to
the benchmark's contract, and a cell, configuration, traffic mix and
per-layer metric can be added by new files and entries alone."""

import json
import re
import shutil

import pytest

from benchmark import cells, drive
from benchmark.conftest import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in SPEC["workloads"]]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][:3] == ["python3", "-m", "benchmark.run"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries_keep_to_the_contract():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
    assert len({c["file"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    assert len({c["source"] for c in SPEC["configs"]}) == len(SPEC["configs"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200 and "\n" not in w["why"]
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m.get("workloads", [])) <= set(WORKLOADS)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_load_by_name(workload):
    cell = cells.load(workload, ROOT)
    assert cell.traffic["generator"] in drive.GENERATORS
    assert cell.config["m"] < cell.config["n"]
    reported = [m["name"] for m in cell.end_to_end if cell.reports(m)]
    assert "setup_s" in reported and len(reported) >= 2
    layer = [m["name"] for m in cell.per_layer if cell.reports(m)]
    assert layer
    for name in layer:
        assert callable(cells.metric_reader(name, ROOT))
    assert cell.limits, "every cell compares at least one number"
    for spec in cell.limits.values():
        assert spec["lower"] < spec["limit"] < spec["upper"]


def test_a_cell_is_added_by_files_alone(tmp_path, small):
    """A copy of the benchmark gains a configuration, a traffic mix, a cell,
    its limits and a per-layer metric through new files and entries; the
    harness runs the new cell and reports the new metric, and no file that
    was there changed."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    spec = json.loads(json.dumps(SPEC))
    bench = tmp_path / "benchmark"
    (bench / "configs" / "tiny.json").write_text(json.dumps(
        {**json.loads((ROOT / SPEC["configs"][0]["file"]).read_text()), "m": 16, "n": 48, "column_block": 16}))
    (bench / "traffic" / "short_window.json").write_text(json.dumps(
        {"generator": "pivot_window", "options": {"pricing": "devex"}, "chunk": 4, "restart_after": 16,
         "sample_chunks": 2}))
    (bench / "limits" / "tiny-devex-window.json").write_text(json.dumps(
        {"compared": {"xb_err": {"limit": 1e-3, "lower": 1e-6, "upper": 1e-1}}}))
    (bench / "metrics" / "window_pivots.py").write_text(
        "def read(ctx):\n    return float(ctx['run'].pivots) if ctx['run'].pivots else None\n")
    spec["configs"].append({"name": "tiny", "source": "a test's own", "file": "benchmark/configs/tiny.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-devex-window", "config": "tiny", "traffic": "short_window",
                              "chips": 1, "why": "test"})
    spec["end_to_end"][0]["workloads"].append("tiny-devex-window")
    spec["per_layer"].append({"name": "window_pivots", "unit": "pivots", "better": "higher",
                              "source": "program_counter", "layer": "solve loop", "moves": "pivots_per_s",
                              "workloads": ["tiny-devex-window"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    from benchmark import run

    cell = cells.load("tiny-devex-window", tmp_path)
    out = run.run_cell(cell, 12345, 0.2, False, "cpu", drive.Clock())
    assert out["correct"] and set(out["metrics"]) == {"pivots_per_s", "setup_s"}
    traced = run.run_cell(cell, 12345, 0.2, True, "cpu", drive.Clock())
    assert traced["metrics"]["window_pivots"]["value"] > 0
    for path, data in before.items():
        assert (tmp_path / path).read_bytes() == data


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "kept").glob("*.json")), ids=lambda p: p.stem)
def test_kept_cell_would_keep_to_the_contract(path):
    """A cell kept out of BENCHMARK.json keeps the entries that put it back,
    each as the contract has it, and its files load by name."""
    from benchmark.conftest import kept_cell

    kept = json.loads(path.read_text())
    assert kept["workload"]["name"] == path.stem and path.stem not in WORKLOADS
    assert set(kept["workload"]) == {"name", "config", "traffic", "chips", "why"}
    assert kept["workload"]["config"] in {c["name"] for c in SPEC["configs"]}
    names = {m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    for m in kept["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source", "workloads"} and m["name"] not in names
        assert 0.01 <= m["bound"] <= 0.25 and m["workloads"] == [path.stem]
    moved = {m["name"] for m in SPEC["end_to_end"] + kept["end_to_end"]}
    for m in kept["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["name"] not in names and m["moves"] in moved and m["workloads"] == [path.stem]
    cell = kept_cell(path.stem)
    assert cell.traffic["generator"] in drive.GENERATORS and cell.limits
    for m in cell.per_layer:
        if cell.reports(m):
            assert callable(cells.metric_reader(m["name"], ROOT))
