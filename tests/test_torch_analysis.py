"""The port's ranging against ``simplex_tpu.analysis.ranging`` and against
brute-force re-solves; the singular-basis ``ok=False`` case. Mirrors
``tests/test_analysis.py``.

Tolerances: ranges against the JAX package's to rtol 1e-4 / atol 1e-5 where
both are finite (two fp32 Newton inversions and (m, m) x (m, n) products
that sum in another order; a range is a ratio of two such numbers), and the
same infinities in the same places; rates against HiGHS re-solves to 1e-5
of |z|, as the JAX tests ask.
"""

import numpy as np
import pytest
import torch

import simplex_tpu
from simplex_tpu.analysis import ranging as jax_ranging
from simplex_tpu.oracle.generator import random_dense_lp
from simplex_tpu.oracle.reference import solve_scipy
from simplex_tpu_torch import RangingResult, SolveStatus, ranging, solve
from simplex_tpu_torch import analysis

FIELDS = ("b_lo", "b_hi", "c_lo", "c_hi", "y", "x")


def assert_ranges_match(got, want):
    for f in FIELDS:
        g, w = np.asarray(getattr(got, f), np.float64), np.asarray(getattr(want, f), np.float64)
        # ranges beyond 1e6 come from entries of B_inv or W at the fp32
        # noise floor: both packages call them (practically) unbounded
        big = (np.abs(w) > 1e6) | ~np.isfinite(w)
        np.testing.assert_array_equal(np.sign(g[big]), np.sign(w[big]), err_msg=f)
        assert np.all((np.abs(g[big]) > 1e5)), f
        np.testing.assert_allclose(g[~big], w[~big], rtol=1e-4, atol=1e-5, err_msg=f)


@pytest.fixture(scope="module")
def solved():
    A, b, c = random_dense_lp(10, 28, seed=23)
    res = solve(A, b, c, device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    return A, b, c, res, ranging(A, b, c, res.basis, device="cpu")


@pytest.mark.parametrize("m,n,seed", [(10, 28, 23), (6, 16, 31), (24, 64, 7), (48, 120, 11)])
def test_ranging_matches_jax(m, n, seed):
    A, b, c = random_dense_lp(m, n, seed=seed)
    res = simplex_tpu.solve(A, b, c)
    got = ranging(A, b, c, np.asarray(res.basis), device="cpu")
    want = jax_ranging(A, b, c, res.basis)
    assert isinstance(got, RangingResult) and got.ok and want.ok
    assert got.b_lo.shape == (m,) and got.c_hi.shape == (n,)
    assert_ranges_match(got, want)


def test_rhs_rate_is_dual(solved):
    A, b, c, res, rng = solved
    checked = 0
    for i in range(len(b)):
        step = min(0.1, 0.5 * rng.b_hi[i]) if rng.b_hi[i] > 1e-6 else 0.0
        if step == 0.0:
            continue
        b2 = np.array(b, np.float64)
        b2[i] += step
        r2 = solve_scipy(A, b2, c)
        assert r2.status == SolveStatus.OPTIMAL
        assert abs((r2.z - res.z) - rng.y[i] * step) < 1e-5 * max(1, abs(res.z))
        checked += 1
    assert checked >= 3


def test_rhs_range_boundary_changes_basis(solved):
    A, b, c, res, rng = solved
    fin = [i for i in range(len(b)) if np.isfinite(rng.b_hi[i]) and rng.b_hi[i] < 10]
    assert fin, "no finite upper rhs range in this instance"
    i = fin[0]
    inside = np.array(b, np.float64)
    inside[i] += 0.9 * rng.b_hi[i]
    ri = solve(A, inside, c, device="cpu")
    assert sorted(ri.basis.tolist()) == sorted(res.basis.tolist())
    outside = np.array(b, np.float64)
    outside[i] += rng.b_hi[i] * 1.5 + 0.1
    ro = solve(A, outside, c, device="cpu")
    if ro.status == SolveStatus.OPTIMAL:
        assert sorted(ro.basis.tolist()) != sorted(res.basis.tolist())


def test_cost_rate_is_primal(solved):
    A, b, c, res, rng = solved
    j = int(res.basis[0])
    assert rng.c_hi[j] > 1e-6, "degenerate cost range"
    step = min(0.05, 0.5 * float(rng.c_hi[j]))
    c2 = np.array(c, np.float64)
    c2[j] += step
    r2 = solve_scipy(A, b, c2)
    assert abs((r2.z - res.z) - rng.x[j] * step) < 1e-5 * max(1, abs(res.z))


def test_nonbasic_cost_hi_is_reduced_cost(solved):
    A, b, c, res, rng = solved
    j = [j for j in range(len(c)) if j not in set(res.basis.tolist())][0]
    slack = float(res.y @ np.asarray(A)[:, j] - c[j])
    assert rng.c_hi[j] == pytest.approx(slack, abs=1e-4)
    assert rng.c_lo[j] == -np.inf
    c2 = np.array(c, np.float64)
    c2[j] += slack + 0.05
    r2 = solve_scipy(A, b, c2)
    assert r2.status == SolveStatus.OPTIMAL and r2.x[j] > 1e-9  # the column entered


def test_basic_cost_range_matches_bruteforce():
    # max 2 x1 + x2 s.t. x1 + x2 + s = 1, basis [x1]: the true delta-c_1
    # range is [-1, +inf) (below c_1 = 1, x2 enters)
    rng = ranging(
        np.array([[1.0, 1.0, 1.0]]), np.array([1.0]), np.array([2.0, 1.0, 0.0]),
        np.array([0], np.int32), device="cpu",
    )
    assert rng.c_lo[0] == pytest.approx(-1.0, abs=1e-5)
    assert np.isinf(rng.c_hi[0]) and rng.c_hi[0] > 0

    A, b, c = random_dense_lp(6, 16, seed=31)
    res = solve(A, b, c, device="cpu")
    r = ranging(A, b, c, res.basis, device="cpu")
    j = int(res.basis[0])
    scanned = 0
    for sign, bound in ((+1, r.c_hi[j]), (-1, r.c_lo[j])):
        if not np.isfinite(bound):
            continue
        inside = np.array(c, np.float64)
        inside[j] += 0.9 * bound
        ri = solve(A, b, inside, device="cpu")
        assert sorted(ri.basis.tolist()) == sorted(res.basis.tolist()), "changed inside the range"
        outside = np.array(c, np.float64)
        outside[j] += 1.5 * bound + sign * 0.05
        ro = solve(A, b, outside, device="cpu")
        assert sorted(ro.basis.tolist()) != sorted(res.basis.tolist()), "unchanged outside the range"
        scanned += 1
    assert scanned >= 1


def test_ranging_reports_ok_flag():
    A = np.array([[1.0, 0.0, 1.0, 0.0], [0.0, 1.0, 0.0, 1.0]])
    r = ranging(A, np.array([2.0, 3.0]), np.array([1.0, 1.0, 0.0, 0.0]), np.array([0, 1], np.int32), device="cpu")
    assert r.ok
    # an exactly singular basis (duplicate column): even the f64 LU fails
    A2 = np.array([[1.0, 1.0, 1.0], [2.0, 2.0, 0.0]])
    r2 = ranging(A2, np.array([1.0, 1.0]), np.zeros(3), np.array([0, 1], np.int32), device="cpu")
    j2 = jax_ranging(A2, np.array([1.0, 1.0]), np.zeros(3), np.array([0, 1], np.int32))
    assert not r2.ok and not j2.ok


def test_ill_conditioned_basis_takes_the_f64_fallback(monkeypatch):
    # a Newton iteration that reports a stalled residual: the ranges then
    # come from the float64 LU inverse and ok stays True
    A, b, c = random_dense_lp(10, 28, seed=23)
    res = solve(A, b, c, device="cpu")
    want = ranging(A, b, c, res.basis, device="cpu")
    inner = analysis.inverse_newton
    monkeypatch.setattr(analysis, "inverse_newton", lambda B: (torch.zeros_like(B), 1.0))
    got = ranging(A, b, c, res.basis, device="cpu")
    monkeypatch.setattr(analysis, "inverse_newton", inner)
    assert got.ok
    assert_ranges_match(got, want)


def test_sparse_and_default_device():
    import scipy.sparse as sps

    A, b, c = random_dense_lp(6, 16, seed=31)
    res = solve(A, b, c, device="cpu")
    # sparse A ranges as the dense A does
    assert_ranges_match(
        ranging(sps.csr_matrix(A), b, c, res.basis, device="cpu"),
        ranging(A, b, c, res.basis, device="cpu"),
    )
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            ranging(A, b, c, res.basis)
