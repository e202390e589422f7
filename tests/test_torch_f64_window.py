"""The float64 dense LP as a benchmark cell (``dense8k-default-window-f64``)
and the pricing layout counter it reads (``hopper.pricing_layouts``).

On the CPU: the cell loads by name and keeps to the benchmark's contract;
its LP is the float32 cell's, widened; its window at a CPU size is correct
against the float64 reference and reads far below the float32 cell's window
on the same seed; planted faults make it not correct; the limits the float32
program sets lie under the float32 cell's own readings, the others come from
the bfloat16 control; the ftran GEMV's frozen count and the name its reader
matches; the layout rule at the cell's shape; the two new readers give None
without a trace or a counter. On the card (marker ``card``; these skip without CUDA, and
import no JAX): the layout counter through graph replays at 1024 x 2048 in
float64. On the card, from the repo root:

    python -m pytest --noconftest -o addopts="" -p no:cacheprovider tests/test_torch_f64_window.py -q -m card
"""

import functools
import json
from pathlib import Path

import pytest
import torch

from benchmark import cells, drive, generate, run
from benchmark.conftest import shrink
from benchmark.roofline import ftran_gemv
from benchmark.tests import faults
from simplex_tpu_torch import SimplexOptions
from simplex_tpu_torch.core import solver, step
from simplex_tpu_torch.core.state import initial_state_slack
from simplex_tpu_torch.kernels import hopper
from simplex_tpu_torch.kernels.dispatch import get_backend

ROOT = Path(__file__).resolve().parents[1]
CELL, CELL32 = "dense8k-default-window-f64", "dense8k-default-window"
SEED = 2**31 + 40961
NEW_READERS = ["pricing_stream_calls_per_pivot", "ftran_gemv_roofline"]
# the compared numbers whose limits the float32 program's readings set
FROM_FLOAT32 = ("binv_err", "y_err")


@pytest.fixture
def card():
    """The CUDA device, or a skip: decided here, never at import time."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); this machine has none")
    return torch.device("cuda")


def _small(workload: str, **traffic):
    """The cell at a CPU test's size (the benchmark tests' ``small``)."""
    sizes = dict(chunk=8, restart_after=64, sample_chunks=6, **traffic)
    return shrink(cells.load(workload, ROOT), 32, 96, 32, **sizes)


@functools.lru_cache(maxsize=None)
def _window(workload: str, trace: bool = False) -> dict:
    return run.run_cell(_small(workload), SEED, 0.3, trace, "cpu", drive.Clock())


def _limits(workload: str) -> dict:
    return json.loads((ROOT / "benchmark" / "limits" / f"{workload}.json").read_text())


# --------------------------------------------------------------------------
# CPU
# --------------------------------------------------------------------------


def test_the_cell_loads_by_name_and_keeps_to_the_contract():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell, cell32 = cells.load(CELL, ROOT), cells.load(CELL32, ROOT)
    assert cell.chips == 1 and cell.traffic == cell32.traffic
    assert cell.config["dtype"] == "float64" and cell32.config["dtype"] == "float32"
    for key in ("generator", "reference", "m", "n", "column_block", "recipe"):
        assert cell.config[key] == cell32.config[key], key
    entry = {c["name"]: c for c in spec["configs"]}[cell.workload["config"]]
    assert entry["reduced"] == [] and entry["source"] == cell.config["source"]
    assert len(entry["source"]) <= 200 and entry["source"] != cell32.config["source"]
    assert [m["name"] for m in cell.end_to_end if cell.reports(m)] == ["pivots_per_s", "setup_s"]
    layer = [m["name"] for m in cell.per_layer if cell.reports(m)]
    assert set(layer) == {
        "device_ops_per_pivot.window", "pricing_scan_roofline", "rank1_update_roofline.window",
        "device_idle_share.window", "head_idle_us_per_pivot.window", "graph_replays_per_pivot.window",
        "graph_ahead_per_pivot.window", "rank1_ftran_calls_per_pivot.window",
        *NEW_READERS,
    }
    for name in layer:
        assert callable(cells.metric_reader(name, ROOT))
    assert cell.limits
    for spec_ in cell.limits.values():
        assert spec_["lower"] < spec_["limit"] < spec_["upper"]


def test_the_lp_is_the_float32_lp_widened():
    cfg32 = {"m": 24, "n": 80, "dtype": "float32", "column_block": 16}
    A32, b32, c32 = generate.dense_canonical(cfg32, SEED, "cpu")
    A, b, c = generate.dense_canonical({**cfg32, "dtype": "float64"}, SEED, "cpu")
    assert A.dtype == b.dtype == c.dtype == torch.float64
    for wide, narrow in ((A, A32), (b, b32), (c, c32)):
        assert torch.equal(wide, narrow.double())


def test_the_window_is_correct_against_the_reference():
    out = _window(CELL)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["checks"]) >= set(_limits(CELL)["compared"])


@pytest.mark.parametrize("number", ["binv_err", "xb_err", "y_err"])
def test_float64_reads_far_below_float32(number):
    wide, narrow = _window(CELL)["checks"][number]["value"], _window(CELL32)["checks"][number]["value"]
    assert narrow > 0 and wide <= 1e-4 * narrow, (wide, narrow)


@pytest.mark.parametrize("fault", [faults.Unchanged, faults.Altered])
def test_a_fault_makes_the_cell_not_correct(fault):
    out = run.run_cell(_small(CELL), SEED, 0.3, False, "cpu", drive.Clock(), faults=fault())
    assert not out["correct"]


@pytest.mark.parametrize("number", FROM_FLOAT32)
def test_the_limit_lies_under_the_float32_readings(number):
    """A limit set between the float64 program and the float32 program:
    the float32 cell's own widest reading of the number fails it too."""
    spec, theirs = _limits(CELL)["compared"][number], _limits(CELL32)
    recorded = {**theirs.get("not_compared", {}), **theirs["compared"]}
    assert spec["lower"] < spec["limit"] < spec["upper"]
    assert spec["limit"] < recorded[number]["lower"]


def test_the_other_limits_come_from_the_bfloat16_control():
    """The numbers whose upper reading is not the float32 program's (the
    drift both precisions read) still fail the bfloat16 control."""
    compared = _limits(CELL)["compared"]
    assert set(FROM_FLOAT32) <= set(compared)
    for name, spec in compared.items():
        if name not in FROM_FLOAT32:
            assert "bfloat16" in spec["why"] and spec["limit"] < spec["upper"], name


def test_ftran_gemv_frozen_count():
    mib = 2**20
    # B_inv's 8192 x 8192 doubles read once, the column in and alpha out
    assert ftran_gemv.nbytes(8192, 8) == 512 * mib + 8 * 2 * 8192
    assert ftran_gemv.nbytes(8192, 4) == 256 * mib + 4 * 2 * 8192
    assert ftran_gemv.flops(8192) == 2.0 * 8192 * 8192


@pytest.mark.parametrize("dtype, layout", [(torch.float64, "stream"), (torch.float32, "split")])
def test_pricing_layout_at_the_cells_shape(dtype, layout):
    cfg = cells.load(CELL, ROOT).config
    m, n = cfg["m"], cfg["n"]
    assert hopper.pricing_layout(dtype, dtype, m, n, n, True) == layout


@pytest.mark.parametrize("name", NEW_READERS)
def test_the_new_readers_give_none_without_a_trace_or_counter(name, monkeypatch):
    read = cells.metric_reader(name, ROOT)
    cell = _small(CELL)
    assert read({"cell": cell, "run": None, "trace": None}) is None
    traced = _window(CELL, True)  # a CPU trace: no kernel launched, no GEMV record
    assert not any(m in traced["metrics"] for m in NEW_READERS)
    summary = {"pivots": 8, "launches": {"pricing_scan": 8}, "rows": 32, "cols": 96, "ops": {},
               "busy_s": 0.0, "window_s": 1.0}
    monkeypatch.delattr(hopper, "pricing_layouts")
    assert read({"cell": cell, "run": None, "trace": summary}) is None


GEMV = {
    "float64": "std::enable_if<!(false), void>::type internal::gemvx::kernel<int, int, double, double, double, "
               "double, false, true, true, false, 7, false, cublasGemvParamsEx<int, cublasGemvTensorStridedBatched"
               "<double const>, cublasGemvTensorStridedBatched<double const>, cublasGemvTensorStridedBatched<double>, "
               "double> >(cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<double const>, "
               "cublasGemvTensorStridedBatched<double const>, cublasGemvTensorStridedBatched<double>, double>)",
    "float32": "void gemv2T_kernel_val<int, int, float, float, float, float, 128, 16, 4, 4, false, false, "
               "cublasGemvParamsEx<int, cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched"
               "<float const>, cublasGemvTensorStridedBatched<float>, float> >(cublasGemvParamsEx<int, "
               "cublasGemvTensorStridedBatched<float const>, cublasGemvTensorStridedBatched<float const>, "
               "cublasGemvTensorStridedBatched<float>, float>, float, float)",
}
NOT_GEMV = [
    "void dot_kernel<double, 128, 0, cublasDotParams<cublasGemvTensor<double const>, cublasGemvTensorStridedBatched"
    "<double> > >(cublasDotParams<cublasGemvTensor<double const>, cublasGemvTensorStridedBatched<double> >)",
    "void reduce_1Block_kernel<double, 128, 7, cublasGemvTensorStridedBatched<double>, cublasGemvTensor<double>, "
    "cublasGemvTensorStridedBatched<double> >(double const*, int, cublasGemvTensorStridedBatched<double>, "
    "cublasGemvTensor<double>, cublasGemvTensorStridedBatched<double>)",
    "Memcpy DtoH (Device -> Pageable)",
]


@pytest.mark.parametrize("workload", [CELL, CELL32])
def test_the_gemv_reader_times_the_gemv_records_alone(workload):
    """The cuBLAS GEMV of either precision, under the name the card's trace
    gives it, against its frozen bound; the dot product's kernels, which
    name GEMV types among their arguments, left out."""
    cell = cells.load(workload, ROOT)
    m, dtype = cell.config["m"], cell.config["dtype"]
    size = 8 if dtype == "float64" else 4
    per_call = 2 * ftran_gemv.nbytes(m, size) / 3.35e12  # at half the HBM peak
    ops = {GEMV[dtype]: {"count": 512, "s": 512 * per_call}}
    ops.update({name: {"count": 512, "s": 1.0} for name in NOT_GEMV})
    summary = {"pivots": 512, "launches": {}, "rows": m, "cols": cell.config["n"], "ops": ops}
    share = cells.metric_reader("ftran_gemv_roofline", ROOT)({"cell": cell, "run": None, "trace": summary})
    assert share == pytest.approx(50.0)


# --------------------------------------------------------------------------
# the card
# --------------------------------------------------------------------------


def _chunk(prob, opts, be, k: int) -> dict:
    hopper.reset_launches()
    s = initial_state_slack(prob, opts.dtype, perturb=opts.perturb_after > 0)
    solver.solve_state(prob, s, opts, k, be)
    return {"layouts": dict(hopper.pricing_layouts), "pricing_scan": hopper.launches["pricing_scan"]}


@pytest.mark.card
def test_a_replayed_chunk_counts_one_stream_call_a_pivot(card):
    opts = SimplexOptions(dtype=torch.float64)
    cfg = {"m": 1024, "n": 2048, "dtype": "float64", "column_block": 512}
    prob = solver.build_problem(*generate.dense_canonical(cfg, SEED, card), opts, card)
    be = get_backend("hopper")
    step.reset_graph_steps()
    graph = _chunk(prob, opts, be, 60)
    assert step.graph_steps["replayed"] > 0
    eager_be = get_backend("hopper")
    eager_be.step_graphs = None
    eager = _chunk(prob, opts, eager_be, 60)
    # the head step prices itself, and every step prices the next one
    assert graph == eager == {"layouts": {"split": 0, "stream": 61}, "pricing_scan": 61}


@pytest.mark.card
def test_reset_launches_clears_the_layout_counter(card):
    opts = SimplexOptions(dtype=torch.float64)
    cfg = {"m": 1024, "n": 2048, "dtype": "float64", "column_block": 512}
    prob = solver.build_problem(*generate.dense_canonical(cfg, SEED, card), opts, card)
    assert _chunk(prob, opts, get_backend("hopper"), 20)["layouts"]["stream"] == 21
    hopper.reset_launches()
    assert hopper.pricing_layouts == {"split": 0, "stream": 0}
    assert all(v == 0 for v in hopper.launches.values())
