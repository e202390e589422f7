"""The port's general-form route (``solve_general``: bounds rewriting,
standardization, phase 1, artificial driveout, phase 2 under native
bounds, presolve) against ``simplex_tpu.core.twophase.solve_general`` and
HiGHS (``solve_scipy_general``), on the CPU.

The structured generators and the HiGHS wrapper are the port's copies;
they are first checked to build the JAX package's instances exactly. The
two packages may walk different paths on degenerate instances, so solves
compare status, z (rel gap <= 1e-5, the fp32 gate), feasibility of x in
f64, and duals where they are unique.
"""

import numpy as np
import pytest
import scipy.sparse
import torch

from simplex_tpu.core import twophase as jtp
from simplex_tpu.oracle import generator as jgen
from simplex_tpu.oracle import reference as jref
from simplex_tpu_torch import GeneralLP, SimplexOptions, SolveStatus, solve_general
from simplex_tpu_torch.core import twophase
from simplex_tpu_torch.oracle import generator as tgen
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy_general

GAP = 1e-5
FEAS = 1e-5

GENERATED = {
    "transport_balanced": ("transportation_lp", (3, 4), dict(seed=1)),
    "transport_unbalanced": ("transportation_lp", (3, 5), dict(seed=2, balanced=False)),
    "assignment": ("assignment_lp", (4,), dict(seed=0)),
    "production": ("production_lp", (8, 5), dict(seed=0)),
    "multiperiod": ("multiperiod_production_lp", (4, 3), dict(seed=0)),
}


def generated(name):
    fn, args, kw = GENERATED[name]
    return getattr(tgen, fn)(*args, **kw)


def hand_built(name):
    """Small instances for the bound rewrites and the exits of the route."""
    if name == "split_reflect_fixed":
        # x0 free (split), x1 <= 3 free below (reflect), x2 fixed at 1.5,
        # x3 in [0.5, 4] (shift + native upper)
        A = np.array([[1.0, 1.0, 1.0, 1.0], [1.0, -1.0, 0.0, 2.0], [1.0, 0.0, 1.0, 0.0]])
        return GeneralLP(
            A=A, b=np.array([6.0, 2.0, 4.0]), c=np.array([1.0, 2.0, -1.0, 3.0]),
            row_types=["L", "G", "E"],
            lower=np.array([-np.inf, -np.inf, 1.5, 0.5]),
            upper=np.array([np.inf, 3.0, 1.5, 4.0]),
        )
    if name == "redundant_row":
        # the second E row repeats the first: its artificial stays basic
        A = np.array([[1.0, 1.0, 0.0], [1.0, 1.0, 0.0], [0.0, 1.0, 1.0]])
        return GeneralLP(A=A, b=np.array([2.0, 2.0, 3.0]), c=np.array([1.0, 2.0, 1.0]),
                         row_types=["E", "E", "L"])
    if name == "negative_rhs":
        A = np.array([[-1.0, -1.0], [1.0, -2.0]])
        return GeneralLP(A=A, b=np.array([-2.0, -4.0]), c=np.array([-1.0, -3.0]),
                         row_types=["L", "G"], upper=np.array([5.0, np.inf]))
    if name == "infeasible":
        A = np.array([[1.0, 1.0], [1.0, 1.0]])
        return GeneralLP(A=A, b=np.array([5.0, 3.0]), c=np.array([1.0, 1.0]),
                         row_types=["G", "L"])
    if name == "unbounded":
        A = np.array([[1.0, -1.0]])
        return GeneralLP(A=A, b=np.array([0.0]), c=np.array([1.0, 1.0]), row_types=["E"])
    if name == "crossed_bounds":
        return GeneralLP(A=np.array([[1.0, 1.0]]), b=np.array([1.0]), c=np.array([1.0, 1.0]),
                         row_types=["L"], lower=np.array([2.0, 0.0]),
                         upper=np.array([1.0, 5.0]))
    raise KeyError(name)


def instance(name):
    return generated(name) if name in GENERATED else hand_built(name)


def check_point(lp, x):
    """x satisfies the rows and bounds of the original LP (f64)."""
    A = np.asarray(lp.A, np.float64)
    r = A @ x - np.asarray(lp.b, np.float64)
    scale = max(1.0, float(np.abs(lp.b).max()))
    for i, t in enumerate(lp.row_types):
        bad = {"L": r[i] > FEAS * scale, "G": r[i] < -FEAS * scale,
               "E": abs(r[i]) > FEAS * scale}[t]
        assert not bad, (i, t, r[i])
    lo = np.zeros(len(x)) if lp.lower is None else np.asarray(lp.lower)
    up = np.full(len(x), np.inf) if lp.upper is None else np.asarray(lp.upper)
    assert np.all(x >= lo - FEAS) and np.all(x <= up + FEAS)


@pytest.mark.parametrize("name", list(GENERATED))
def test_generators_match_jax(name):
    fn, args, kw = GENERATED[name]
    t, j = getattr(tgen, fn)(*args, **kw), getattr(jgen, fn)(*args, **kw)
    for f in ("A", "b", "c", "lower", "upper"):
        tv, jv = getattr(t, f), getattr(j, f)
        assert (tv is None) == (jv is None), f
        if tv is not None:
            np.testing.assert_array_equal(tv, jv, err_msg=f)
    assert list(t.row_types) == list(j.row_types)
    rt, rj = solve_scipy_general(t), jref.solve_scipy_general(j)
    assert rt.status == rj.status and rt.z == rj.z


@pytest.mark.parametrize(
    "name",
    list(GENERATED) + ["split_reflect_fixed", "redundant_row", "negative_rhs"],
)
def test_optimal_matches_jax_and_highs(name):
    lp = instance(name)
    res = solve_general(lp, device="cpu")
    ref = jtp.solve_general(jtp.GeneralLP(*lp))
    hi = solve_scipy_general(lp)
    assert res.status == SolveStatus.OPTIMAL == int(ref.status) == hi.status
    assert relative_gap(res.z, hi.z) <= GAP and relative_gap(res.z, ref.z) <= GAP
    check_point(lp, res.x)
    assert abs(float(np.dot(lp.c, res.x)) - res.z) <= GAP * max(1.0, abs(res.z))
    assert res.y is not None and res.y.shape == (len(lp.b),)
    assert res.warm is not None and res.warm.basis.shape == (len(lp.b),)
    if name in ("transport_unbalanced", "assignment", "multiperiod", "redundant_row"):
        assert res.phase1_iters > 0 and res.iters >= res.phase1_iters


@pytest.mark.parametrize("name", ["infeasible", "unbounded", "crossed_bounds"])
def test_exits_match_jax_and_highs(name):
    lp = instance(name)
    res = solve_general(lp, device="cpu")
    ref = jtp.solve_general(jtp.GeneralLP(*lp))
    want = {"infeasible": SolveStatus.INFEASIBLE, "unbounded": SolveStatus.UNBOUNDED,
            "crossed_bounds": SolveStatus.INFEASIBLE}[name]
    assert res.status == want == int(ref.status) == solve_scipy_general(lp).status
    assert res.y is None and res.warm is None
    assert np.isnan(res.z) == np.isnan(ref.z)  # phase 2 exits report c.x
    if name == "crossed_bounds":
        assert res.iters == 0 == ref.iters


def test_redundant_row_duals():
    # y must satisfy the dual rows c_j = y . A_j at the basic columns,
    # with no big-M leak into the redundant row
    lp = instance("redundant_row")
    res = solve_general(lp, device="cpu")
    assert np.all(np.abs(res.y) < 10.0)
    x = res.x
    A, c = np.asarray(lp.A), np.asarray(lp.c)
    basic = x > 1e-7
    np.testing.assert_allclose(res.y @ A[:, basic], c[basic], atol=1e-5)


@pytest.mark.parametrize("name", ["production", "split_reflect_fixed", "multiperiod"])
def test_presolve_matches_jax(name):
    lp = instance(name)
    res = solve_general(lp, presolve=True, device="cpu")
    ref = jtp.solve_general(jtp.GeneralLP(*lp), presolve=True)
    hi = solve_scipy_general(lp)
    assert res.status == SolveStatus.OPTIMAL == int(ref.status)
    assert relative_gap(res.z, hi.z) <= GAP and relative_gap(res.z, ref.z) <= GAP
    check_point(lp, res.x)
    assert res.warm is None
    if name == "production":  # nondegenerate: x and y are unique
        np.testing.assert_allclose(res.x, ref.x, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(res.y, ref.y, rtol=1e-4, atol=1e-4)


def test_presolve_decides_alone():
    # every row a singleton: presolve fixes the point on the host
    lp = GeneralLP(A=np.eye(2), b=np.array([1.0, 2.0]), c=np.array([1.0, 1.0]),
                   row_types=["E", "E"])
    res = solve_general(lp, presolve=True, device="cpu")
    ref = jtp.solve_general(jtp.GeneralLP(*lp), presolve=True)
    assert res.status == SolveStatus.OPTIMAL == int(ref.status) and res.iters == 0
    np.testing.assert_allclose(res.x, [1.0, 2.0])
    assert res.z == ref.z == 3.0


@pytest.mark.parametrize(
    "cfg",
    [
        dict(backend="hopper"),
        dict(pricing_dtype="bfloat16", partial_pricing=4, partial_min_segment=2,
             update_defer=4, refactor_every=32),
        dict(ratio="classic", bland_after=4),
    ],
)
def test_options_through_the_route(cfg):
    lp = instance("multiperiod")
    res = solve_general(lp, options=SimplexOptions(**cfg), device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    assert relative_gap(res.z, solve_scipy_general(lp).z) <= GAP
    check_point(lp, res.x)


def test_fp32_phase1_tolerance_reads_the_torch_dtype(monkeypatch):
    # phase 1 ending at z1 = -5e-7 * max|b| is feasible at the fp32
    # tolerance (1e-5) and infeasible at the f64 one (1e-8)
    lp = instance("transport_unbalanced")
    real_solve = twophase.solve
    calls = []

    def shifted(*a, **k):
        r = real_solve(*a, **k)
        calls.append(r)
        if len(calls) == 1:  # phase 1
            r = r._replace(z=-5e-7 * float(np.abs(a[1]).max()))
        return r

    monkeypatch.setattr(twophase, "solve", shifted)
    assert solve_general(lp, device="cpu").status == SolveStatus.OPTIMAL
    calls.clear()
    f64 = SimplexOptions(dtype=torch.float64, backend="torch")
    assert solve_general(lp, options=f64, device="cpu").status == SolveStatus.INFEASIBLE


def test_warm_sparse_and_device_raise():
    lp = instance("production")
    res = solve_general(lp, device="cpu")
    # the token is consumed: no phase 1, the dual loop finds the stored
    # basis still optimal, and the result carries a token of its own
    again = solve_general(lp, warm=res.warm, device="cpu")
    assert again.status == SolveStatus.OPTIMAL and again.phase1_iters == 0
    assert again.iters == 0 and relative_gap(again.z, res.z) <= GAP
    np.testing.assert_array_equal(np.sort(again.warm.basis), np.sort(res.warm.basis))
    with pytest.raises(ValueError, match="presolve"):
        solve_general(lp, warm=res.warm, presolve=True, device="cpu")
    # a sparse A takes the same route (ported): the same optimum and token
    sp = solve_general(lp._replace(A=scipy.sparse.csc_matrix(lp.A)), device="cpu")
    assert sp.status == SolveStatus.OPTIMAL and relative_gap(sp.z, res.z) <= GAP
    np.testing.assert_array_equal(np.sort(sp.warm.basis), np.sort(res.warm.basis))
    if torch.cuda.is_available():
        assert solve_general(lp).status == SolveStatus.OPTIMAL
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            solve_general(lp)


def test_driveout_matches_jax():
    lp2, _, _ = twophase._preprocess_bounds(instance("multiperiod"))
    A_std, b, _, _, _, art, basis1, _, u_std = twophase._standardize(lp2)
    j_std = jtp._standardize(jtp.GeneralLP(*lp2._replace(A=lp2.A.toarray())))
    A_std = A_std.toarray()  # the port standardizes on float64 CSC
    np.testing.assert_array_equal(A_std, j_std[0])
    np.testing.assert_array_equal(basis1, j_std[6])
    np.testing.assert_array_equal(u_std, j_std[8])
    # the phase-1 start itself: every artificial basic
    art_set = set(art.tolist())
    got = twophase._drive_out_artificials(A_std, basis1, art_set)
    want = jtp._drive_out_artificials(A_std, basis1, art_set)
    np.testing.assert_array_equal(got, want)
