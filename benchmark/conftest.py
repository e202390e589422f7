"""Fixtures of the benchmark's own tests (``benchmark/tests``)."""

import dataclasses
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import time."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); this machine has none")
    return torch.device("cuda")


def shrink(cell, m: int, n: int, block: int, **traffic):
    """``cell`` at a size a CPU test run holds: (m, n), its structural
    columns in blocks of ``block``, traffic parameters changed as given."""
    cfg = {**cell.config, "m": m, "n": n, "column_block": block}
    return dataclasses.replace(cell, config=cfg, traffic={**cell.traffic, **traffic})


def _cell_from_files(workload: dict, end_to_end: list, per_layer: list):
    """A cell built from its files by the names ``workload`` gives, with
    ``BENCHMARK.json``'s metric entries and the given ones beside them."""
    import json

    from benchmark import cells

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench = ROOT / "benchmark"
    name, config, traffic = workload["name"], workload["config"], workload["traffic"]
    return cells.Cell(
        workload=workload,
        config={**json.loads((bench / "configs" / f"{config}.json").read_text()), "name": config},
        traffic={**json.loads((bench / "traffic" / f"{traffic}.json").read_text()), "name": traffic},
        limits=json.loads((bench / "limits" / f"{name}.json").read_text())["compared"],
        end_to_end=spec["end_to_end"] + end_to_end, per_layer=spec["per_layer"] + per_layer, root=ROOT,
    )


def sharded_cell():
    """The four-card cell whose files the benchmark keeps without a
    ``BENCHMARK.json`` entry (left out until its runs spread less):
    ``dense_32768x131072_fp32_4chip`` under ``default_window_4chip``."""
    workload = {"name": "sharded32k-default-window-4chip", "config": "dense_32768x131072_fp32_4chip",
                "traffic": "default_window_4chip", "chips": 4, "why": ""}
    return _cell_from_files(workload, [], [])


def kept_cell(name: str):
    """A single-card cell kept out of ``BENCHMARK.json`` with the entries
    that would put it back (``kept/<name>.json``): its workload and the
    metrics only it reports."""
    import json

    kept = json.loads((ROOT / "benchmark" / "kept" / f"{name}.json").read_text())
    return _cell_from_files(kept["workload"], kept["end_to_end"], kept["per_layer"])


def any_cell(name: str):
    """The cell ``name``: from ``BENCHMARK.json``, else a kept one."""
    from benchmark import cells

    if (ROOT / "benchmark" / "kept" / f"{name}.json").exists():
        return kept_cell(name)
    return cells.load(name, ROOT)


@pytest.fixture
def small():
    """small(workload or cell) -> the cell at a CPU test's size."""
    sizes = {
        "pivot_window": dict(chunk=8, restart_after=64, sample_chunks=6),
        "solve_to_optimal": dict(instances=2, sample_steps_below=10, max_steps_per_solve=2000),
    }

    def make(workload, m: int = 32, n: int = 96, block: int = 32, **traffic):
        cell = any_cell(workload) if isinstance(workload, str) else workload
        return shrink(cell, m, n, block, **{**sizes[cell.traffic["generator"]], **traffic})

    return make
