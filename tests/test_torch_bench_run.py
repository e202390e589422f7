"""The port's benchmark entry point (``simplex_tpu_torch.bench.run``) against
``bench.py``, on the CPU at tiny sizes.

Each case runs ``bench.py`` under JAX on the CPU in a subprocess (no
compilation cache written) and ``run.main`` in this process with
``--device cpu`` on the same arguments, and holds the two records to each
other: the same ``metric`` and ``unit``; ``bench.py``'s keys all present
and no key beyond them but ``impl``, ``backend``, ``card``, ``launches``
and ``feas_err``; pivots and status equal on the tie-free dense instances
(single, parity, sparse, general: read from the records and the stderr
lines both print); ``tile_density`` and the PDHG iteration counts equal;
every gap field within its gate (1e-5; 1e-4 for the sampled warm
re-solves; 1e-3 for PDHG at tol 1e-4). Times are CPU times and are not
compared. The entry points' own checks follow: the argument checks of
``bench.py``, no run without a card unless ``--device cpu``, and ``cli
bench``.
"""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from simplex_tpu_torch import SimplexOptions
from simplex_tpu_torch.bench import run
from simplex_tpu_torch.core.solver import build_problem
from simplex_tpu_torch.oracle.generator import random_dense_lp

ROOT = Path(__file__).resolve().parents[1]
ADDED = {"impl", "backend", "card", "launches", "feas_err"}
PDHG_GAP, REOPT_GAP, GAP = 1e-3, 1e-4, 1e-5

# (bench.py arguments, the gap fields of its record with their gate)
CASES = {
    "single": ("--m 64 --n 160 --pivots 16", {}),
    "parity": ("--mode parity --m 32 --n 80", {"value": GAP}),
    "batch": ("--mode batch --batch 8", {}),
    "reopt": ("--mode reopt --m 32 --n 80 --batch 8", {"worst_sampled_rel_gap_vs_highs": REOPT_GAP}),
    "general": ("--mode general --periods 4 --products 4", {"rel_gap_vs_highs": GAP}),
    "pdhg": ("--mode pdhg --m 32 --n 80", {"obj_rel_gap_vs_highs": PDHG_GAP}),
    "pdhg sparse": ("--mode pdhg --sparse --m 132", {"obj_rel_gap_vs_highs": PDHG_GAP}),
    "sparse": ("--mode sparse --m 256 --n 512 --pivots 64", {}),
}
# what the stderr lines say of the pivots and the status, where the record
# does not carry them
LOG_PATTERNS = {
    "single": r"warmup: \S+ iters=(\d+) status=(\d+)\n(?:.*\n)*?(\d+) pivots in",
    "parity": r"\n(\w+) z=\S+ iters=(\d+) ",
    "general": r"\n(\w+) z=\S+ iters=(\d+) \(phase1 (\d+)\)",
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def bench_py(args):
    """``bench.py ARGS`` under JAX on the CPU: (return code, stdout, stderr)."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "JAX_COMPILATION_CACHE_DIR": ""}
    out = subprocess.run(
        [sys.executable, "bench.py", *args], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=300,
    )
    return out.returncode, out.stdout, out.stderr


def port(args, capsys):
    """``run.main(ARGS + --device cpu)`` in this process: (record, stderr);
    stdout must be exactly one JSON line."""
    capsys.readouterr()
    assert run.main([*args, "--device", "cpu"]) == 0
    out, err = capsys.readouterr()
    lines = out.splitlines()
    assert len(lines) == 1, out
    return json.loads(lines[0]), err


@pytest.mark.parametrize("case", list(CASES))
def test_record_matches_bench_py(case, capsys):
    args, gaps = CASES[case]
    args = args.split()
    rc, out, jerr = bench_py(args)
    assert rc == 0, jerr[-2000:]
    want = json.loads(out.strip().splitlines()[-1])
    got, err = port(args, capsys)

    assert got["metric"] == want["metric"] and got["unit"] == want["unit"]
    assert set(want) <= set(got) and set(got) - set(want) <= ADDED, sorted(got)
    assert got["impl"] == "simplex_tpu_torch" and got["backend"] == "hopper" and got["card"] is None
    assert set(got["launches"]) == set(run.hopper.launches)
    # plain versions on CPU tensors: no kernel launched
    assert not any(got["launches"].values())
    if case in ("parity", "reopt", "sparse"):
        assert "feas_err" in got
    else:
        assert "feas_err" not in got
    for field, gate in gaps.items():
        assert want[field] <= gate and got[field] <= gate, (field, want[field], got[field])
    if case in LOG_PATTERNS:
        pat = LOG_PATTERNS[case]
        assert re.search(pat, err).groups() == re.search(pat, jerr).groups()
    if case == "parity":
        assert got["pivots"] == want["pivots"]
    if case == "general":
        assert got["pivots"] == want["pivots"]
    if case == "sparse":
        assert got["iters"] == want["iters"] and got["status"] == want["status"]
    if case in ("sparse", "pdhg sparse"):
        assert got["tile_density"] == want["tile_density"]
    if case.startswith("pdhg"):
        assert got["iters"] == want["iters"]
    if case == "reopt":
        assert got["mean_pivots"] == want["mean_pivots"]
        assert got["feas_err"] <= REOPT_GAP


def test_window_launches_leave_the_callers_count_whole(monkeypatch):
    """A record's launches are its window's; the counters run on, so a
    caller that counts the whole run (``chip_smoke.py``) sees every launch."""
    monkeypatch.setitem(run.hopper.launches, "ratio_eta", 5)

    def window():
        run.hopper.launches["ratio_eta"] += 3

    _, _, launches = run._timed(torch.device("cpu"), window)
    assert launches["ratio_eta"] == 3 and run.hopper.launches["ratio_eta"] == 8


def test_no_card_no_run(monkeypatch):
    """Without ``--device`` the run needs a card and raises before it builds
    anything; nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "MODE_FNS", {})  # a mode that ran would KeyError
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--m", "32", "--n", "80"])


def test_parity_needs_the_oracle(capsys):
    with pytest.raises(SystemExit) as exc:
        run.parse_args(["--mode", "parity", "--no-oracle"])
    assert exc.value.code == 2
    assert "--no-oracle is incompatible with --mode parity" in capsys.readouterr().err


def test_small_is_512x1024():
    args = run.parse_args(["--small", "--m", "64", "--n", "128"])
    assert (args.m, args.n) == (512, 1024)


@pytest.mark.parametrize("pricing", ["devex", "steepest"])
def test_weighted_pricing_turns_multiple_pricing_off(pricing, capsys):
    assert run.parse_args([]).multi_price == 64
    args = run.parse_args(["--pricing", pricing])
    assert args.multi_price == 0
    assert f"--pricing {pricing}: multiple pricing is dantzig-only; forcing --multi-price 0" in capsys.readouterr().err


def test_sparse_needs_more_columns_than_rows():
    args = ["--mode", "sparse", "--m", "64", "--n", "64"]
    rc, out, jerr = bench_py(args)
    with pytest.raises(SystemExit) as exc:
        run.main([*args, "--device", "cpu"])
    assert rc == 1 and out == ""
    assert jerr.strip().splitlines()[-1] == str(exc.value.code)


def test_single_window_takes_the_uploaded_tensors():
    """The single mode's window starts from A, b and c on the device:
    ``build_problem`` takes the tensors in place (no copy)."""
    A, b, c = (torch.from_numpy(v) for v in random_dense_lp(16, 40, seed=0))
    prob = build_problem(A, b, c, SimplexOptions(), torch.device("cpu"))
    assert all(p.data_ptr() == t.data_ptr() for p, t in ((prob.A, A), (prob.b, b), (prob.c, c)))


@pytest.mark.parametrize("shape", [(256, 512), (30, 300), (200, 700), (5, 7)])
def test_tile_density_is_the_block_sparse_one(shape):
    """``run.tile_density`` against ``simplex_tpu.sparse.from_dense``'s
    stored tiles and ``tile_density()``: on ``bench.py --mode sparse``'s
    recipe, and on a zero matrix (one tile is always kept)."""
    from simplex_tpu import sparse as jax_sparse

    m, n = shape
    A = run.sparse_instance(m, n)[0] if n > m else np.zeros(shape, np.float32)
    M = jax_sparse.from_dense(A, block_shape=(run.TILE, run.TILE))
    assert run.tile_density(A) == (M.n_tiles, M.tile_density())


def test_cli_bench():
    """``cli bench`` runs the benchmark in a subprocess and returns its exit
    code; stdout is the one record."""
    out = subprocess.run(
        [sys.executable, "-m", "simplex_tpu_torch.cli", "bench", "--m", "32", "--n", "80",
         "--pivots", "8", "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.splitlines()
    assert len(lines) == 1
    rec = json.loads(lines[0])
    assert rec["metric"] == "pivots_per_sec_dense_32x80_fp32" and rec["impl"] == "simplex_tpu_torch"
    assert re.search(r"\n8 pivots in ", out.stderr)


def test_cli_bench_fails_without_a_card():
    """Without ``--device cpu`` on a machine with no card the subprocess
    fails and ``cli bench`` returns its exit code."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    out = subprocess.run(
        [sys.executable, "-m", "simplex_tpu_torch.cli", "bench", "--m", "32", "--n", "80"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0 and out.stdout == ""
    assert "no CUDA device" in out.stderr
