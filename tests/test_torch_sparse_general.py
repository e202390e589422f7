"""The general-form route on a sparse A: ``read_mps(sparse=True)`` ->
sparse bound rewriting and standardization (scipy CSC on the host) ->
two-phase on the device with a sparse A, against the dense route, the JAX
package's sparse route and HiGHS; the warm token and presolve on sparse A;
the standardization and the artificial driveout against their dense
versions. Mirrors ``tests/test_sparse_general.py``.

Tolerances: status exactly; z to rel gap 1e-6 against the dense route and
1e-5 (the fp32 gate) against HiGHS and the JAX package; duals to rtol 1e-4
/ atol 1e-6 as there; the standardized matrices exactly.
"""

import os

import numpy as np
import pytest
import scipy.sparse as sps

from simplex_tpu.core import twophase as jtp
from simplex_tpu_torch import GeneralLP, SimplexOptions, SolveStatus, read_mps, solve_general
from simplex_tpu_torch.core import twophase
from simplex_tpu_torch.oracle.generator import multiperiod_production_lp, transportation_lp
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy_general

DATA = os.path.join(os.path.dirname(__file__), "data")
FIXTURES = ["transport2x3.mps", "multiperiod16x8.mps", "prod_bounded.mps",
            "blend_ranges.mps", "freevar_mi.mps"]


def general_pair(prob):
    """(dense GeneralLP, sparse GeneralLP) of one MPS problem."""
    c = prob.c if prob.maximize else -prob.c
    A_d = prob.A.toarray() if sps.issparse(prob.A) else np.asarray(prob.A)

    def mk(A):
        return GeneralLP(A=A, b=prob.b, c=c, row_types=prob.row_types,
                         lower=prob.lower, upper=prob.upper)

    return mk(A_d), mk(sps.csc_matrix(A_d))


@pytest.mark.parametrize("fname", FIXTURES)
def test_read_mps_sparse_equals_dense(fname):
    d = read_mps(os.path.join(DATA, fname))
    s = read_mps(os.path.join(DATA, fname), sparse=True)
    assert sps.issparse(s.A)
    np.testing.assert_array_equal(s.A.toarray(), d.A)
    for f in ("b", "c", "lower", "upper"):
        np.testing.assert_array_equal(getattr(s, f), getattr(d, f))
    assert s.row_types == d.row_types and s.c0 == d.c0


@pytest.mark.parametrize("fname", FIXTURES)
def test_solve_general_sparse_matches_dense_jax_and_highs(fname):
    lp_d, lp_s = general_pair(read_mps(os.path.join(DATA, fname), sparse=True))
    rd = solve_general(lp_d, device="cpu")
    rs = solve_general(lp_s, device="cpu")
    rj = jtp.solve_general(jtp.GeneralLP(*lp_s))
    assert rs.status == rd.status == int(rj.status)
    if rd.status == SolveStatus.OPTIMAL:
        assert relative_gap(rs.z, rd.z) < 1e-6
        np.testing.assert_allclose(rs.y, rd.y, rtol=1e-4, atol=1e-6)
        assert relative_gap(rs.z, solve_scipy_general(lp_d).z) < 1e-5
        assert relative_gap(rs.z, rj.z) < 1e-5


@pytest.mark.parametrize("which", ["transportation", "multiperiod"])
def test_sparse_general_structured_instances(which):
    # structured instances whose sparsity is real, against HiGHS
    lp = (transportation_lp(12, 10, seed=3, balanced=False) if which == "transportation"
          else multiperiod_production_lp(6, 4, seed=2))
    lp_s = lp._replace(A=sps.csc_matrix(np.asarray(lp.A)))
    rs = solve_general(lp_s, device="cpu")
    ref = solve_scipy_general(lp)
    assert rs.status == ref.status == SolveStatus.OPTIMAL
    assert relative_gap(rs.z, ref.z) < 1e-5


def test_sparse_general_infeasible():
    lp = GeneralLP(A=sps.csc_matrix(np.array([[1.0, 1.0], [1.0, 1.0]])), b=np.array([1.0, 3.0]),
                   c=np.array([1.0, 1.0]), row_types=["E", "E"])
    assert solve_general(lp, device="cpu").status == SolveStatus.INFEASIBLE


def test_sparse_general_warm_restart():
    lp = transportation_lp(8, 6, seed=4, balanced=False)
    lp_s = lp._replace(A=sps.csc_matrix(np.asarray(lp.A)))
    cold = solve_general(lp_s, device="cpu")
    assert cold.status == SolveStatus.OPTIMAL and cold.warm is not None
    b2 = np.asarray(lp.b, np.float64) * 1.05
    warm = solve_general(lp_s._replace(b=b2), warm=cold.warm, device="cpu")
    ref = solve_scipy_general(lp._replace(b=b2))
    assert warm.status == ref.status
    if ref.status == SolveStatus.OPTIMAL:
        assert warm.phase1_iters == 0 and relative_gap(warm.z, ref.z) < 1e-5


@pytest.mark.parametrize("fname", ["prod_bounded.mps", "blend_ranges.mps"])
def test_sparse_general_presolve(fname):
    lp_d, lp_s = general_pair(read_mps(os.path.join(DATA, fname), sparse=True))
    rd = solve_general(lp_d, presolve=True, device="cpu")
    rs = solve_general(lp_s, presolve=True, device="cpu")
    assert rs.status == rd.status == SolveStatus.OPTIMAL
    assert relative_gap(rs.z, rd.z) < 1e-6


@pytest.mark.parametrize("fname", FIXTURES)
def test_standardization_sparse_equals_dense(fname):
    lp_d, lp_s = general_pair(read_mps(os.path.join(DATA, fname), sparse=True))
    pd, _, zd = twophase._preprocess_bounds(lp_d)
    ps, _, zs = twophase._preprocess_bounds(lp_s)
    assert sps.issparse(ps.A) and zs == zd
    np.testing.assert_array_equal(ps.A.toarray(), pd.A.toarray())
    np.testing.assert_array_equal(ps.b, pd.b)
    sd = twophase._standardize(pd)
    ss = twophase._standardize(ps)
    assert sps.issparse(ss[0]) and sps.issparse(sd[0])
    np.testing.assert_array_equal(ss[0].toarray(), sd[0].toarray())
    for a, b in zip(ss[1:], sd[1:]):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_driveout_sparse_equals_dense():
    # rows with no +1 slack start on artificials; a phase-1-like basis with
    # basic artificials is driven out the same way on both storages
    lp = transportation_lp(4, 5, seed=1, balanced=True)
    A_std, b, c, k, n_real, art_cols, basis1, flips, u = twophase._standardize(lp)
    got = twophase._drive_out_artificials(A_std, basis1, set(art_cols.tolist()))
    want = twophase._drive_out_artificials(A_std.toarray(), basis1, set(art_cols.tolist()))
    np.testing.assert_array_equal(got, want)
    assert set(got.tolist()) != set(basis1.tolist())


def test_sparse_general_options():
    lp = multiperiod_production_lp(6, 4, seed=5)
    lp_s = lp._replace(A=sps.csc_matrix(np.asarray(lp.A)))
    ref = solve_scipy_general(lp)
    for opts in (SimplexOptions(pricing="steepest"),
                 SimplexOptions(pricing_dtype="bfloat16", update_defer=4, multi_price=8,
                                partial_pricing=2, partial_min_segment=1)):
        rs = solve_general(lp_s, options=opts, device="cpu")
        assert rs.status == SolveStatus.OPTIMAL and relative_gap(rs.z, ref.z) < 1e-5
