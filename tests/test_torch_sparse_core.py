"""Sparse A through the port's solve entry points (``solve``, ``solve_dual``,
``reoptimize``, ``ranging``) against the JAX package's sparse solves
(``BlockSparse`` and scipy input) and HiGHS: the default path, the bf16
shadow, multiple pricing with deferred updates, segmented pricing over
sparse segments, devex and steepest edge, native bounds, a given basis,
``pricing_sparse`` over a dense A, and the sparse twins of the dual step
and of ranging. Mirrors ``tests/test_sparse_core.py`` and the simplex half
of ``tests/test_sparse.py``.

Tolerances: status exactly; z to rel gap 1e-5 (the fp32 gate) against
HiGHS and the other package; feas_err below 1e-5; the exact steepest-edge
norms to rtol 1e-8 in float64; ranges as ``tests/test_torch_analysis.py``
compares them. Pivot counts only on the tie-free sample.
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

import simplex_tpu
from simplex_tpu import sparse as bsp
from simplex_tpu.oracle.reference import relative_gap, solve_scipy
from simplex_tpu_torch import SimplexOptions, SolveStatus, ranging, reoptimize, solve, solve_dual
from simplex_tpu_torch import sparse as sp
from simplex_tpu_torch.core import step
from simplex_tpu_torch.core.solver import build_problem
from simplex_tpu_torch.core.state import initial_state_slack
from simplex_tpu_torch.io.text import load_lp
from tests.test_torch_analysis import assert_ranges_match

GAP = 1e-5


def sparse_canonical(m, n, density, seed):
    """``tests/test_sparse.py``'s ``[A0 | I]`` instance, float32."""
    rng = np.random.default_rng(seed)
    k = n - m
    A0 = rng.uniform(0.2, 1.5, (m, k))
    A0[rng.uniform(size=A0.shape) > density] = 0.0
    A = np.hstack([A0, np.eye(m)]).astype(np.float32)
    b = (A0 @ rng.uniform(0.2, 0.8, k) + rng.uniform(0.1, 1.0, m)).astype(np.float32)
    c = np.concatenate([rng.uniform(0.5, 2, k), np.zeros(m)]).astype(np.float32)
    c[:k] *= (A0 != 0).any(axis=0)
    return A, b, c


def bounded(m, k, seed, density=0.3):
    A, b, c = sparse_canonical(m, m + k, density, seed)
    u = np.concatenate([np.random.default_rng(seed).uniform(0.3, 1.0, k), np.full(m, np.inf)])
    return A, b, c, u.astype(np.float32)


def carried(A, block=(16, 16)):
    """The same matrix as a JAX BlockSparse and as the port's SparseA."""
    M = bsp.from_dense(A, block_shape=block)
    P = sp.from_block_sparse(np.asarray(M.tiles), np.asarray(M.rows), np.asarray(M.cols),
                             M.shape, device="cpu")
    return M, P


def check(res, A, b, c, jres=None):
    ref = solve_scipy(A, b, c)
    assert ref.status == SolveStatus.OPTIMAL
    assert res.status == SolveStatus.OPTIMAL
    assert relative_gap(res.z, ref.z) < GAP and res.feas_err < 1e-5
    if jres is not None:
        assert int(jres.status) == SolveStatus.OPTIMAL
        assert relative_gap(res.z, jres.z) < GAP


OPTION_SETS = {
    "default": dict(refactor_every=16),
    "bf16": dict(pricing_dtype="bfloat16"),
    "multi_defer": dict(multi_price=4, update_defer=4, refactor_every=32),
    "devex": dict(pricing="devex", refactor_every=16),
    "steepest": dict(pricing="steepest", refactor_every=16),
    "steepest_defer": dict(pricing="steepest", update_defer=4, ratio="classic"),
}


@pytest.mark.parametrize("backend", ["hopper", "torch"])
@pytest.mark.parametrize("name", list(OPTION_SETS))
def test_solve_sparse_matches_jax_and_highs(name, backend):
    A, b, c = sparse_canonical(24, 60, 0.2, seed=21)
    M, P = carried(A)
    opts = OPTION_SETS[name]
    res = solve(P, b, c, options=SimplexOptions(backend=backend, **opts), device="cpu")
    jres = simplex_tpu.solve(M, b, c, options=simplex_tpu.SimplexOptions(**opts))
    check(res, A, b, c, jres)
    dense = solve(A, b, c, options=SimplexOptions(backend=backend, **opts), device="cpu")
    assert relative_gap(res.z, dense.z) < GAP


def test_solve_sparse_scipy_input_and_sample_path():
    A, b, c = sparse_canonical(16, 40, 0.25, seed=22)
    for fmt in (sps.csr_matrix, sps.csc_matrix, sps.coo_matrix):
        check(solve(fmt(A), b, c, device="cpu"), A, b, c)
    # the tie-free sample: the dense path's pivots exactly
    A, b, c = (np.asarray(v, np.float32) for v in load_lp("tests/data/sample.txt"))
    res, dense = solve(sps.csc_matrix(A), b, c, device="cpu"), solve(A, b, c, device="cpu")
    assert res.iters == dense.iters == 2
    np.testing.assert_array_equal(res.basis, dense.basis)


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_solve_sparse_segmented_pricing(pdtype):
    A, b, c = sparse_canonical(24, 64, 0.25, seed=34)
    M, P = carried(A, (8, 8))
    opts = dict(partial_pricing=4, partial_min_segment=1, pricing_dtype=pdtype)
    prob = build_problem(P, b, c, SimplexOptions(**opts), "cpu")
    assert len(prob.A_segs) == 4 and all(s.shape == (24, 16) for s in prob.A_segs)
    res = solve(P, b, c, options=SimplexOptions(**opts), device="cpu")
    check(res, A, b, c, simplex_tpu.solve(M, b, c, options=simplex_tpu.SimplexOptions(**opts)))
    # a segment width that does not divide n: segmented pricing is off
    prob = build_problem(P, b, c, SimplexOptions(partial_pricing=5, partial_min_segment=1), "cpu")
    assert prob.A_segs is None
    check(solve(P, b, c, options=SimplexOptions(partial_pricing=5, partial_min_segment=1),
                device="cpu"), A, b, c)


@pytest.mark.parametrize("opts", [dict(), dict(partial_pricing=4, partial_min_segment=1),
                                  dict(pricing="devex"), dict(pricing_dtype="bfloat16")])
def test_solve_sparse_bounded(opts):
    A, b, c, u = bounded(8, 24, seed=35)
    base = simplex_tpu.solve(A, b, c, u=u)
    M, P = carried(A, (8, 8))
    res = solve(P, b, c, u=u, options=SimplexOptions(**opts), device="cpu")
    jres = simplex_tpu.solve(M, b, c, u=u, options=simplex_tpu.SimplexOptions(**opts))
    assert res.status == int(base.status) == int(jres.status) == SolveStatus.OPTIMAL
    assert relative_gap(res.z, base.z) < GAP and relative_gap(res.z, jres.z) < GAP
    assert res.feas_err < 1e-5 and res.at_upper is not None


@pytest.mark.parametrize("pricing", ["dantzig", "devex", "steepest"])
def test_solve_sparse_from_a_given_basis(pricing):
    # a non-slack start: the basis matrix gathered from sparse A (and under
    # steepest edge the chunked norms through B_inv)
    A, b, c = sparse_canonical(12, 30, 0.3, seed=26)
    ref = solve(A, b, c, device="cpu")
    res = solve(sps.csc_matrix(A), b, c, basis0=ref.basis,
                options=SimplexOptions(pricing=pricing), device="cpu")
    assert res.status == SolveStatus.OPTIMAL and res.iters <= 2
    assert relative_gap(res.z, ref.z) < 1e-6


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
def test_pricing_sparse_over_dense_a(pdtype):
    A, b, c = sparse_canonical(24, 60, 0.2, seed=6)
    opts = dict(pricing_sparse=True, pricing_dtype=pdtype, refactor_every=64)
    prob = build_problem(A, b, c, SimplexOptions(**opts), "cpu")
    assert isinstance(prob.A_price, sp.SparseA) and isinstance(prob.A, torch.Tensor)
    res = solve(A, b, c, options=SimplexOptions(**opts), device="cpu")
    check(res, A, b, c, simplex_tpu.solve(A, b, c, options=simplex_tpu.SimplexOptions(**opts)))


def test_pricing_sparse_bounded_and_segment_refusal():
    A, b, c, u = bounded(8, 20, seed=8)
    base = simplex_tpu.solve(A, b, c, u=u)
    res = solve(A, b, c, u=u, options=SimplexOptions(pricing_sparse=True), device="cpu")
    assert res.status == int(base.status) == SolveStatus.OPTIMAL
    assert relative_gap(res.z, base.z) < GAP
    with pytest.raises(NotImplementedError, match="partial_pricing"):
        solve(A, b, c, options=SimplexOptions(pricing_sparse=True, partial_pricing=4,
                                              partial_min_segment=1), device="cpu")


def test_sparse_steepest_gamma_exact_per_pivot():
    # the same exact Goldfarb-Reid norms as the dense path, held against a
    # float64 recomputation at every pivot
    rng = np.random.default_rng(30)
    m, k = 10, 24
    A0 = rng.uniform(0.2, 1.5, (m, k))
    A0[rng.uniform(size=A0.shape) > 0.4] = 0.0
    A = np.hstack([A0, np.eye(m)])
    b = A0 @ rng.uniform(0.2, 0.8, k) + rng.uniform(0.1, 1.0, m)
    c = np.concatenate([rng.uniform(0.5, 2, k), np.zeros(m)])
    opts = SimplexOptions(pricing="steepest", dtype=torch.float64, backend="torch")
    prob = build_problem(sps.csc_matrix(A), b, c, opts, "cpu")
    state = initial_state_slack(prob, torch.float64, pricing="steepest")
    from simplex_tpu_torch.kernels.dispatch import get_backend

    backend = get_backend("torch")
    for _ in range(100):
        state = step.pivot_step(prob, state, opts, backend)
        if int(state.status) != SolveStatus.RUNNING:
            break
        basis = state.basis.numpy()
        T = np.linalg.solve(A[:, basis], A)
        gamma_ref = 1 + np.sum(T * T, axis=0)
        nonbasic = np.ones(A.shape[1], bool)
        nonbasic[basis] = False
        np.testing.assert_allclose(state.gamma.numpy()[nonbasic], gamma_ref[nonbasic], rtol=1e-8)
    assert int(state.iters) >= 3 and int(state.status) == SolveStatus.OPTIMAL


@pytest.mark.parametrize("pricing", ["dantzig", "devex", "steepest"])
def test_solve_dual_sparse_warm(pricing):
    A, b, c = sparse_canonical(12, 30, 0.3, seed=33)
    M, P = carried(A, (8, 8))
    opts = SimplexOptions(pricing=pricing)
    cold = solve(P, b, c, options=opts, device="cpu")
    assert cold.status == SolveStatus.OPTIMAL
    b2 = (np.asarray(b, np.float64) * 1.06).astype(np.float32)
    warm = solve_dual(P, b2, c, basis0=cold.basis, options=opts, device="cpu")
    jwarm = simplex_tpu.solve_dual(M, b2, c, basis0=cold.basis,
                                   options=simplex_tpu.SimplexOptions(pricing=pricing))
    check(warm, A, b2, c, jwarm)
    again = reoptimize(sps.csc_matrix(A), b2, c, cold, options=opts, device="cpu")
    assert again.status == SolveStatus.OPTIMAL and relative_gap(again.z, warm.z) < GAP


def test_solve_dual_sparse_bounded_long_step():
    A, b, c, u = bounded(10, 30, seed=40, density=0.5)
    cold = solve(sps.csc_matrix(A), b, c, u=u, device="cpu")
    assert cold.status == SolveStatus.OPTIMAL
    b2 = (np.asarray(b, np.float64) * 1.3).astype(np.float32)
    warm = reoptimize(sps.csc_matrix(A), b2, c, cold, u=u, device="cpu")
    dense = reoptimize(A, b2, c, cold, u=u, device="cpu")
    assert warm.status == dense.status
    if warm.status == SolveStatus.OPTIMAL:
        assert relative_gap(warm.z, dense.z) < GAP


def test_solve_dual_sparse_entry_check():
    # the float64 entry check reads a sparse A too: a cost change is refused
    A, b, c = sparse_canonical(12, 30, 0.3, seed=36)
    cold = solve(A, b, c, device="cpu")
    c2 = c.copy()
    c2[np.flatnonzero(~np.isin(np.arange(30), cold.basis))[0]] += 50.0
    with pytest.raises(ValueError, match="dual-feasible"):
        solve_dual(sps.csc_matrix(A), b, c2, basis0=cold.basis, device="cpu")


def test_ranging_sparse_matches_dense_and_jax(monkeypatch):
    A, b, c = sparse_canonical(16, 40, 0.3, seed=37)
    res = solve(A, b, c, device="cpu")
    dense = ranging(A, b, c, res.basis, device="cpu")
    M, P = carried(A, (8, 8))
    got = ranging(P, b, c, res.basis, device="cpu")
    assert got.ok
    assert_ranges_match(got, dense)
    assert_ranges_match(got, simplex_tpu.ranging(M, b, c, res.basis))
    # column chunks smaller than n: the same ranges
    from simplex_tpu_torch import analysis

    real = analysis._cost_rows
    monkeypatch.setattr(analysis, "_cost_rows", lambda A, B, r, nb, chunk=512: real(A, B, r, nb, 7))
    assert_ranges_match(ranging(sps.csr_matrix(A), b, c, res.basis, device="cpu"), dense)


def test_bench_sparse_recipe_feas_err_against_jax():
    # bench.py --mode sparse's recipe under steepest edge without
    # re-inversion, both packages, dense and sparse A: the same status and
    # z, and the port's float64 primal infeasibility no larger than the
    # reference's (tests/bench_sparse_drift.py runs it at 4096 x 8192)
    from tests.bench_sparse_drift import bench_sparse_lp, solve_both

    A, b, c = bench_sparse_lp(1024, 2048)
    runs = solve_both(A, b, c)
    z = runs["jax dense"][2]
    for name, (status, _, zi, feas, _) in runs.items():
        assert status == SolveStatus.OPTIMAL, name
        assert relative_gap(zi, z) < GAP, name
    worst_ref = max(runs["jax dense"][3], runs["jax sparse"][3])
    for name in ("port dense", "port sparse"):
        assert runs[name][3] <= worst_ref + 1e-5, (name, runs[name][3], worst_ref)
