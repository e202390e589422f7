"""The readers of the program's host spans (``simplex_tpu_torch.spans``):
finite on the window cell shrunk to a CPU run with its trace on, and None,
not an error, from a program that records no spans."""

import math
import sys

import pytest

from benchmark import cells, drive, run

READERS = ("head_idle_us_per_pivot.window", "host_us_per_pivot.window", "host_reads_per_pivot.window")
CHUNK = 4


@pytest.fixture(scope="module")
def traced():
    from benchmark.conftest import any_cell, shrink

    cell = shrink(any_cell("dense8k-default-window"), 24, 64, 16, chunk=CHUNK, restart_after=16, sample_chunks=2)
    out = run.run_cell(cell, 2**31 + 7, 0.1, True, "cpu", drive.Clock())
    return cell, out


def test_the_readers_give_finite_values(traced):
    _, out = traced
    assert out["correct"]
    for name in READERS:
        v = out["metrics"][name]["value"]
        assert math.isfinite(v) and v > 0, (name, v)
    # one control read a pivot and the one at the chunk's start
    assert out["metrics"]["host_reads_per_pivot.window"]["value"] == (CHUNK + 1) / CHUNK


def test_the_readers_give_none_without_spans(traced, monkeypatch):
    import simplex_tpu_torch

    cell, out = traced
    monkeypatch.delattr(simplex_tpu_torch, "spans")
    monkeypatch.setitem(sys.modules, "simplex_tpu_torch.spans", None)
    ctx = {"cell": cell, "run": None, "trace": {"pivots": CHUNK}}
    for name in READERS:
        assert cells.metric_reader(name, cell.root)(ctx) is None
