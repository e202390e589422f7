"""The port's per-op bench and timing helpers, on the CPU at a tiny size.

The numbers a CPU run gives are host times of PyTorch's CPU kernels; these
tests check only the record's shape: the JAX package's op names (the
block-sparse SpMVs included) and the
products of steepest edge, the dual step and ranging, one ``{"ms", "gbps"}``
record each (``ranging_W`` also its TFLOP/s), and the JSON line ``main``
prints. The
Hopper backend given CPU tensors runs the plain versions and builds
nothing.
"""

import json

import pytest
import torch

from simplex_tpu_torch.bench import kernels as bk
from simplex_tpu_torch.bench.timing import PhaseTimer, elapsed_ms, trace
from simplex_tpu_torch.kernels import _build, hopper

OPS = [
    "pricing_argmin",
    "ftran",
    "ratio_argmin",
    "rank1_update",
    "pricing_segment_bf16",
    "flush_rankL_amortized",
    "pricing_update2",
    "pricing_update_two_mv",
    "steepest_u",
    "ranging_W",
]
# one 128 x 128 tile covers these shapes: tile density 1
SPARSE_OPS = ["bsp_matvec_density1.00", "bsp_rmatvec_density1.00"]


@pytest.fixture
def no_library(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    hopper.reset_launches()
    yield
    assert not any(hopper.launches.values())


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_bench_ops_records(backend, no_library):
    res = bk.bench_ops(16, 64, k=2, backend=backend, device="cpu")
    assert list(res) == OPS + SPARSE_OPS
    for op, rec in res.items():
        assert set(rec) == ({"ms", "gbps", "tflops"} if op == "ranging_W" else {"ms", "gbps"}), op
        assert rec["ms"] >= 0 and rec["gbps"] >= 0, op


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_bench_ops_records_in_float64(backend, no_library):
    # the same ops on float64 A, B_inv and vectors: every byte count doubles
    # but the bf16 segment's and the sparse index's
    res = bk.bench_ops(16, 64, k=2, backend=backend, device="cpu", dtype=torch.float64)
    assert list(res) == OPS + SPARSE_OPS
    assert all(rec["ms"] >= 0 and rec["gbps"] >= 0 for rec in res.values())
    line = json.loads(bk.record_line(16, 64, backend, "cpu", res, torch.float64))
    assert line["dtype"] == "float64" and list(line["ops"]) == OPS + SPARSE_OPS


def test_bench_ops_skips_segments_when_n_does_not_divide(no_library):
    res = bk.bench_ops(8, 60, k=1, backend="torch", device="cpu")
    assert "pricing_segment_bf16" not in res
    assert list(res) == [op for op in OPS if op != "pricing_segment_bf16"] + SPARSE_OPS


def test_main_prints_one_json_line(capsys, no_library):
    bk.main(["--m", "16", "--n", "64", "--k", "2", "--backend", "torch", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    rec = json.loads(out[0])
    assert set(rec) == {"m", "n", "backend", "dtype", "device", "ops", "total_pivot_ms"}
    assert (rec["m"], rec["n"], rec["backend"], rec["dtype"], rec["device"]) == (16, 64, "torch", "float32", "cpu")
    assert list(rec["ops"]) == OPS + SPARSE_OPS
    assert rec["total_pivot_ms"] == pytest.approx(sum(v["ms"] for v in rec["ops"].values()), abs=1e-3)


def test_main_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError):
        bk.main(["--m", "8", "--n", "16", "--k", "1"])


def test_batch_kernels_bench_needs_a_card(capsys):
    """The batched kernels' timer measures the card only: without one it
    prints no record and returns 1."""
    from simplex_tpu_torch.bench import batch_kernels

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert batch_kernels.main(["--tag", "x"]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_timing_helpers_on_cpu(tmp_path):
    t = PhaseTimer("cpu")
    with t.phase("solve"):
        torch.ones(8).sum()
    with t.phase("solve"):
        pass
    assert list(t.durations) == ["solve"] and t.durations["solve"] >= 0
    assert "solve" in t.report() and "Total" in t.report()
    calls = []
    assert elapsed_ms(lambda: calls.append(1), "cpu") >= 0 and calls == [1]
    with trace(None) as prof:
        assert prof is None
    with trace(str(tmp_path)):
        torch.ones(4) @ torch.ones(4)
    assert (tmp_path / "trace.json").exists()


def test_profile_general_rehearses_on_cpu(tmp_path, capsys, no_library):
    # the general route's phase-1 profile: one record per instance, each
    # from the phase-1 solver call alone (stopped at the window)
    from simplex_tpu_torch.bench import profile_general as pg

    out = tmp_path / "profile.json"
    assert pg.main(["--device", "cpu", "--window", "5", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert list(recs) == ["A default", "A bench-general", "B default", "B bench-general", "C default"]
    for tag, rec in recs.items():
        assert (rec["status"], rec["pivots"], rec["pivots_profiled"]) == ("MAX_ITER", 5, 5), tag
        assert rec["phase1_wall_s"] > 0 and rec["device_ops_per_pivot"] >= 0, tag
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.split(" {")[0] in recs]
    assert len(printed) == len(recs)


def test_profile_canonical_rehearses_on_cpu(tmp_path, capsys, no_library):
    # the canonical pivot loop's profile: one record per option set, each
    # from a warm-up, a timed and a traced stretch of one solve's pivot loop
    from simplex_tpu_torch.bench import profile_canonical as pc

    out = tmp_path / "profile.json"
    assert pc.main(["--device", "cpu", "--warm", "3", "--window", "5", "--out", str(out)]) == 0
    recs = json.loads(out.read_text())
    assert list(recs) == [
        "default", "flagship, multi-price 64", "flagship, multi-price off",
        "devex", "steepest", "steepest, defer 16",
    ]
    for tag, rec in recs.items():
        assert (rec["status"], rec["pivots_timed"], rec["pivots_traced"]) == (0, 5, 5), tag
        assert rec["wall_ms_per_pivot"] > 0 and rec["device_ops_per_pivot"] > 0, tag
        assert rec["steps_per_pivot"] >= 1.0, tag
        assert set(rec["launches_per_pivot"]) == set(hopper.launches), tag
        assert rec["host_reads_per_pivot"]["control"] >= 1.0, tag
    # the weighted rules' stale flag rides on the control read
    for tag in ("devex", "steepest", "steepest, defer 16"):
        assert recs[tag]["host_reads_per_pivot"]["branch"] == 0.0, tag
    printed = [ln for ln in capsys.readouterr().out.splitlines() if ln.split(" {")[0] in recs]
    assert len(printed) == len(recs)


def test_profile_canonical_only_and_dual(tmp_path, capsys, no_library):
    # --only picks option sets by name; --dual adds the dual loop's stretch
    # after a rhs move, from the default solve's basis
    from simplex_tpu_torch.bench import profile_canonical as pc

    out = tmp_path / "profile.json"
    args = ["--device", "cpu", "--warm", "4", "--window", "4", "--only", "steepest",
            "--dual", "--dual-scale", "0.3", "--out", str(out)]
    assert pc.main(args) == 0
    recs = json.loads(out.read_text())
    assert list(recs) == ["steepest", "steepest, defer 16", "dual"]
    dual = recs["dual"]
    assert dual["b_scale"] == 0.3 and dual["cold_pivots"] > 0
    assert dual["pivots_traced"] >= 1 and dual["host_reads_per_pivot"]["branch"] == 0.0
    assert set(dual["launches_per_pivot"]) == set(hopper.launches)
