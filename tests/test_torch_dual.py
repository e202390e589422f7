"""The port's dual simplex, warm restarts and the general route's ``warm=``
against the JAX package's: one dual step from the same JAX state (with and
without bounds, the bound-flipping long step on and off, a case with tied
breakpoints), ``solve_dual`` / ``reoptimize`` / ``solve_general(warm=)``
against ``simplex_tpu`` and HiGHS, INFEASIBLE by Farkas, and the
not-dual-feasible ``ValueError``. Mirrors ``tests/test_dual.py``.

Tolerances: indices, flags and counts exactly; float leaves to rtol / atol
1e-5 after one step (fp32 products that sum in another order); z to rel gap
1e-5 (the fp32 gate), 1e-4 where the JAX test of the same case allows it
(bounded warm re-solves); feas_err below 1e-4 as there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.optimize import linprog

import simplex_tpu
from simplex_tpu.analysis import reoptimize as jax_reoptimize
from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.core import dual as jdual
from simplex_tpu.core.state import Problem as JaxProblem
from simplex_tpu.core.state import initial_state as jax_initial
from simplex_tpu.core.twophase import GeneralLP as JaxGeneralLP
from simplex_tpu.core.twophase import solve_general as jax_solve_general
from simplex_tpu.kernels.dispatch import get_backend as jax_backend
from simplex_tpu.oracle.generator import multiperiod_production_lp, random_dense_lp
from simplex_tpu.oracle.reference import relative_gap, solve_scipy, solve_scipy_general
from simplex_tpu_torch import (
    GeneralLP,
    SimplexOptions,
    SolveStatus,
    ranging,
    reoptimize,
    solve,
    solve_dual,
    solve_general,
)
from simplex_tpu_torch.core import dual, step
from simplex_tpu_torch.core.state import problem_from_numpy, state_from_numpy
from simplex_tpu_torch.kernels import dispatch, hopper

JB = jax_backend("xla")
JDUAL = jax.jit(lambda p, s, o: jdual.dual_pivot_step(p, s, o, JB), static_argnums=2)
OPTS = dict(refactor_every=64)


def perturbed(b, seed, scale):
    rng = np.random.default_rng(seed)
    return (np.asarray(b, np.float64) * (1 + scale * rng.uniform(-1, 1, b.shape))).astype(b.dtype)


def bounded_instance(m, k, seed, tight=0.6):
    """``tests/test_dual.py``'s bounded canonical LP: most columns carry
    finite, fairly tight upper bounds (the long step's workload)."""
    rng = np.random.default_rng(seed)
    A0 = rng.uniform(0.2, 1.5, (m, k))
    A = np.hstack([A0, np.eye(m)]).astype(np.float32)
    b = (A0 @ rng.uniform(0.2, 0.8, k) + rng.uniform(0.1, 1.0, m)).astype(np.float32)
    c = np.concatenate([rng.uniform(0.5, 2, k), np.zeros(m)]).astype(np.float32)
    u = np.concatenate([rng.uniform(0.2, tight, k), np.full(m, np.inf)]).astype(np.float32)
    return A, b, c, u


def oracle_bounded(A, b, c, u):
    r = linprog(
        -np.asarray(c, np.float64), A_eq=np.asarray(A, np.float64),
        b_eq=np.asarray(b, np.float64),
        bounds=[(0, float(ui) if np.isfinite(ui) else None) for ui in u], method="highs",
    )
    return -r.fun if r.status == 0 else None


def leaves(s):
    d = {
        f: np.asarray(getattr(s, f))
        for f in ("B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen", "last_refac")
    }
    d["at_upper"] = None if s.at_upper is None else np.asarray(s.at_upper)
    return d


def close(t, j, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=what)


def assert_same(ts, js):
    np.testing.assert_array_equal(ts.basis.numpy(), np.asarray(js.basis))
    for f in ("status", "iters", "degen"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    for f in ("B_inv", "x_b", "y", "c_b"):
        close(getattr(ts, f), getattr(js, f), f)
    if js.at_upper is not None:
        np.testing.assert_array_equal(ts.at_upper.numpy(), np.asarray(js.at_upper))


def entry_states(A, b2, c, basis, u=None, at_upper=None):
    """The JAX dual-entry state of ``basis`` under the new rhs ``b2``, and
    the two packages' problems."""
    A, b2, c = (np.asarray(v, np.float32) for v in (A, b2, c))
    ju = None if u is None else jnp.asarray(np.asarray(u, np.float32))
    jp = JaxProblem(jnp.asarray(A), jnp.asarray(b2), jnp.asarray(c), u=ju)
    js = jax_initial(jp, np.asarray(basis), jnp.float32, at_upper0=at_upper)
    return jp, problem_from_numpy(A, b2, c, "cpu", u=u), js


def walk_both(jp, tp, js, jopts, topts, steps, backend="hopper"):
    """Step both packages from the same state each time; returns how many
    steps pivoted and whether any step flipped a bound without entering."""
    be = dispatch.get_backend(backend)
    took, flipped = 0, False
    for _ in range(steps):
        ts = state_from_numpy(leaves(js), "cpu")
        js1 = JDUAL(jp, js, jopts)
        ts1 = dual.dual_pivot_step(tp, ts, topts, be)
        assert_same(ts1, js1)
        if int(js1.status) != SolveStatus.RUNNING:
            break
        if js.at_upper is not None:
            changed = np.asarray(js1.at_upper) != np.asarray(js.at_upper)
            flipped |= int(changed.sum()) > 2
        took += 1
        js = js1
    return took, flipped, js1


# --------------------------------------------------------------------------
# one dual step from the same JAX state
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("bland_after", [64, 1])
def test_dual_steps_match_jax_unbounded(backend, bland_after):
    # bland_after = 1: Bland's leaving and entering rules from the first
    # degenerate step on
    A, b, c = random_dense_lp(16, 40, seed=11)
    cold = simplex_tpu.solve(A, b, c)
    b2 = perturbed(b, seed=5, scale=0.25)
    jp, tp, js = entry_states(A, b2, c, cold.basis)
    took, _, last = walk_both(
        jp, tp, js, JaxOptions(bland_after=bland_after),
        SimplexOptions(bland_after=bland_after, backend=backend), 12, backend,
    )
    assert took >= 2
    assert int(last.status) in (SolveStatus.RUNNING, SolveStatus.OPTIMAL)


@pytest.mark.parametrize("dual_flip", [True, False])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_dual_steps_match_jax_bounded(dual_flip, seed):
    A, b, c, u = bounded_instance(10, 28, seed)
    cold = simplex_tpu.solve(A, b, c, u=u)
    rng = np.random.default_rng(seed + 50)
    b2 = (np.asarray(b, np.float64) * (1 + 0.5 * rng.uniform(-1, 1, b.shape))).astype(np.float32)
    jp, tp, js = entry_states(A, b2, c, cold.basis, u, cold.at_upper)
    took, _, _ = walk_both(
        jp, tp, js, JaxOptions(dual_flip=dual_flip), SimplexOptions(dual_flip=dual_flip), 12
    )
    assert took >= 1


def test_long_step_flips_bounds():
    # somewhere on these walks the long step passes a finite-bound column:
    # more than the entering and the leaving flag change in one step
    seen = False
    for seed in (3, 4, 5):
        A, b, c, u = bounded_instance(10, 28, seed)
        cold = simplex_tpu.solve(A, b, c, u=u)
        rng = np.random.default_rng(seed + 50)
        b2 = (np.asarray(b, np.float64) * (1 + 0.5 * rng.uniform(-1, 1, b.shape))).astype(np.float32)
        jp, tp, js = entry_states(A, b2, c, cold.basis, u, cold.at_upper)
        seen |= walk_both(jp, tp, js, JaxOptions(), SimplexOptions(), 12)[1]
    assert seen


def test_long_step_with_tied_breakpoints():
    # three copies of every structural column: equal costs, bounds and
    # entries give exactly tied breakpoints mu_j; the walk must pass them in
    # index order (a stable sort), as jnp.argsort does
    A, b, c, u = bounded_instance(6, 8, 7)
    k = 8
    A = np.hstack([A[:, :k]] * 3 + [A[:, k:]])
    c = np.concatenate([c[:k]] * 3 + [c[k:]])
    u = np.concatenate([u[:k] / 3] * 3 + [u[k:]])
    cold = simplex_tpu.solve(A, b, c, u=u)
    assert int(cold.status) == SolveStatus.OPTIMAL
    b2 = (b * np.linspace(0.3, 1.6, len(b))).astype(np.float32)
    jp, tp, js = entry_states(A, b2, c, cold.basis, u, cold.at_upper)
    took, flipped, _ = walk_both(jp, tp, js, JaxOptions(), SimplexOptions(), 10)
    assert took >= 1 and flipped


def test_terminal_dual_step_and_reads():
    # a primal-feasible entry state: the step sets OPTIMAL, changes nothing
    # else, launches nothing, and costs one read
    A, b, c = random_dense_lp(12, 30, seed=4)
    cold = simplex_tpu.solve(A, b, c)
    jp, tp, js = entry_states(A, b, c, cold.basis)
    ts = state_from_numpy(leaves(js), "cpu")
    step.reset_host_reads()
    ts1 = dual.dual_pivot_step(tp, ts, SimplexOptions(), dispatch.get_backend("hopper"))
    js1 = JDUAL(jp, js, JaxOptions())
    assert step.host_reads == {"control": 1, "branch": 0}
    assert int(ts1.status) == int(js1.status) == SolveStatus.OPTIMAL
    assert int(ts1.iters) == 0 and ts1.B_inv is ts.B_inv and ts1.x_b is ts.x_b


def test_dual_loop_reads_once_a_pivot_and_updates_through_the_backend(monkeypatch):
    A, b, c, u = bounded_instance(10, 28, 3)
    cold = simplex_tpu.solve(A, b, c, u=u)
    rng = np.random.default_rng(53)
    b2 = (np.asarray(b, np.float64) * (1 + 0.5 * rng.uniform(-1, 1, b.shape))).astype(np.float32)
    _, tp, js = entry_states(A, b2, c, cold.basis, u, cold.at_upper)
    ts = state_from_numpy(leaves(js), "cpu")
    calls = []
    inner = hopper.rank1_update
    monkeypatch.setattr(hopper, "rank1_update", lambda *a: calls.append(1) or inner(*a))
    step.reset_host_reads()
    out = dual.dual_solve_state(tp, ts, SimplexOptions(verify_terminal=False), 500)
    assert int(out.status) == SolveStatus.OPTIMAL
    pivots = int(out.iters)
    assert pivots >= 1 and len(calls) == pivots
    # one read a pivot and one for the terminal step; no branch reads: the
    # long step's flip flag rides on the control read
    assert step.host_reads == {"control": pivots + 1, "branch": 0}
    assert out.U is None and out.e is None


# --------------------------------------------------------------------------
# solve_dual, reoptimize
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["hopper", "torch"])
@pytest.mark.parametrize("m,n", [(16, 40), (48, 120)])
def test_warm_rhs_resolve_matches_jax_and_oracle(backend, m, n):
    A, b, c = random_dense_lp(m, n, seed=11)
    cold = solve(A, b, c, options=SimplexOptions(backend=backend, **OPTS), device="cpu")
    jcold = simplex_tpu.solve(A, b, c, options=JaxOptions(**OPTS))
    b2 = perturbed(b, seed=5, scale=0.25)
    ref = solve_scipy(A, b2, c)
    warm = reoptimize(A, b2, c, cold, options=SimplexOptions(backend=backend, **OPTS), device="cpu")
    jwarm = jax_reoptimize(A, b2, c, jcold, options=JaxOptions(**OPTS))
    assert warm.status == SolveStatus.OPTIMAL == int(jwarm.status) == ref.status
    assert relative_gap(warm.z, ref.z) < 1e-5 and relative_gap(warm.z, jwarm.z) < 1e-5
    assert warm.feas_err < 1e-4
    # the duals of the re-solve price b2 (strong duality)
    assert abs(float(warm.y @ np.asarray(b2, np.float64)) - warm.z) < 1e-3 * (1 + abs(warm.z))


@pytest.mark.parametrize("pricing", ["dantzig", "devex", "steepest"])
def test_warm_resolve_under_each_pricing_rule(pricing):
    # the hand-over re-derives e and (steepest) the exact weights
    A, b, c = random_dense_lp(24, 64, seed=3)
    opts = SimplexOptions(pricing=pricing)
    cold = solve(A, b, c, options=opts, device="cpu")
    b2 = perturbed(b, seed=9, scale=0.3)
    warm = reoptimize(A, b2, c, cold, options=opts, device="cpu")
    jwarm = simplex_tpu.core.dual.solve_dual(
        A, b2, c, basis0=cold.basis, options=JaxOptions(pricing=pricing)
    )
    assert warm.status == SolveStatus.OPTIMAL == int(jwarm.status)
    assert relative_gap(warm.z, solve_scipy(A, b2, c).z) < 1e-5
    assert relative_gap(warm.z, jwarm.z) < 1e-5


def test_warm_is_much_cheaper_than_cold():
    A, b, c = random_dense_lp(64, 160, seed=3)
    opts = SimplexOptions(**OPTS)
    cold = solve(A, b, c, options=opts, device="cpu")
    b2 = perturbed(b, seed=9, scale=0.05)
    cold2 = solve(A, b2, c, options=opts, device="cpu")
    warm = reoptimize(A, b2, c, cold, options=opts, device="cpu")
    assert warm.status == SolveStatus.OPTIMAL
    assert relative_gap(warm.z, cold2.z) < 1e-5
    assert warm.iters <= max(4, cold2.iters // 4), (warm.iters, cold2.iters)


def test_rhs_inside_ranging_band_needs_no_pivots():
    A, b, c = random_dense_lp(24, 64, seed=7)
    opts = SimplexOptions(**OPTS)
    cold = solve(A, b, c, options=opts, device="cpu")
    rng = ranging(A, b, c, cold.basis, device="cpu")
    # each b_i moves by 40% of its allowable slack: the basis cannot change
    db = 0.4 * np.where(np.isfinite(rng.b_hi), rng.b_hi, 0.0) + 0.4 * np.where(
        np.isfinite(rng.b_lo) & ~np.isfinite(rng.b_hi), rng.b_lo, 0.0
    )
    b2 = (np.asarray(b, np.float64) + db).astype(np.float32)
    warm = reoptimize(A, b2, c, cold, options=opts, device="cpu")
    assert warm.status == SolveStatus.OPTIMAL
    assert warm.iters == 0
    assert relative_gap(warm.z, solve_scipy(A, b2, c).z) < 1e-5
    np.testing.assert_array_equal(np.sort(warm.basis), np.sort(cold.basis))


def test_rhs_outside_ranging_band_pivots():
    A, b, c = random_dense_lp(24, 64, seed=7)
    cold = solve(A, b, c, device="cpu")
    rng = ranging(A, b, c, cold.basis, device="cpu")
    i = int(np.argmax(np.where(np.isfinite(rng.b_lo), -rng.b_lo, -np.inf)))
    b2 = np.asarray(b, np.float64).copy()
    b2[i] += 1.5 * rng.b_lo[i]  # past the lower end of row i's range
    b2 = b2.astype(np.float32)
    ref = solve_scipy(A, b2, c)
    warm = reoptimize(A, b2, c, cold, device="cpu")
    jwarm = jax_reoptimize(A, b2, c, simplex_tpu.solve(A, b, c))
    assert warm.status == ref.status == int(jwarm.status)
    if ref.status == SolveStatus.OPTIMAL:
        assert warm.iters > 0
        assert relative_gap(warm.z, ref.z) < 1e-5


@pytest.mark.parametrize("bounded", [False, True])
def test_infeasible_rhs_change_detected(bounded):
    # a sum of nonnegatives cannot be negative: the dual goes unbounded
    # (with bounds: even after flipping every bounded column)
    A = np.array([[1.0, 1.0, 1.0]], np.float32)
    c = np.array([-1.0, -2.0, 0.0], np.float32)
    u = np.array([1.0, 1.0, np.inf], np.float32) if bounded else None
    b = np.array([2.5 if bounded else 5.0], np.float32)
    b2 = np.array([-0.5 if bounded else -1.0], np.float32)
    cold = solve(A, b, c, u=u, device="cpu")
    assert cold.status == SolveStatus.OPTIMAL
    warm = solve_dual(A, b2, c, basis0=cold.basis, u=u, at_upper0=cold.at_upper, device="cpu")
    jwarm = jdual.solve_dual(A, b2, c, basis0=cold.basis, u=u, at_upper0=cold.at_upper)
    assert warm.status == SolveStatus.INFEASIBLE == int(jwarm.status)


def test_dual_from_scratch_slack_basis():
    # all costs <= 0: the slack basis is dual-feasible even with negative b
    rng = np.random.default_rng(2)
    m, n = 12, 30
    A = np.hstack([rng.uniform(-1, 1, (m, n - m)), np.eye(m)]).astype(np.float32)
    b = rng.uniform(-2, 2, m).astype(np.float32)
    c = np.concatenate([-rng.uniform(0.5, 2, n - m), np.zeros(m)]).astype(np.float32)
    ref = solve_scipy(A, b, c)
    res = solve_dual(A, b, c, options=SimplexOptions(**OPTS), device="cpu")
    jres = jdual.solve_dual(A, b, c, options=JaxOptions(**OPTS))
    assert res.status == ref.status == int(jres.status)
    if ref.status == SolveStatus.OPTIMAL:
        assert relative_gap(res.z, ref.z) < 1e-5


@pytest.mark.parametrize("dual_flip", [True, False])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_bounded_warm_resolve(dual_flip, seed):
    A, b, c, u = bounded_instance(10, 28, seed)
    opts = SimplexOptions(dual_flip=dual_flip, **OPTS)
    cold = solve(A, b, c, u=u, options=opts, device="cpu")
    assert cold.status == SolveStatus.OPTIMAL
    rng = np.random.default_rng(seed + 50)
    b2 = (np.asarray(b, np.float64) * (1 + 0.5 * rng.uniform(-1, 1, b.shape))).astype(np.float32)
    z_ref = oracle_bounded(A, b2, c, u)
    warm = solve_dual(
        A, b2, c, basis0=cold.basis, u=u, at_upper0=cold.at_upper, options=opts, device="cpu"
    )
    jwarm = jdual.solve_dual(
        A, b2, c, basis0=cold.basis, u=u, at_upper0=cold.at_upper,
        options=JaxOptions(dual_flip=dual_flip, **OPTS),
    )
    assert int(jwarm.status) == warm.status
    if z_ref is None:
        assert warm.status == SolveStatus.INFEASIBLE
    else:
        assert warm.status == SolveStatus.OPTIMAL
        assert relative_gap(warm.z, z_ref) < 1e-4 and warm.feas_err < 1e-4


def test_entry_contract_rejects_dual_infeasible_basis():
    A = np.array([[1.0, 1.0]], np.float32)  # slack basis = column 1
    b = np.array([-1.0], np.float32)
    c = np.array([1.0, 0.0], np.float32)
    with pytest.raises(ValueError, match="dual-feasible"):
        solve_dual(A, b, c, device="cpu")
    with pytest.raises(ValueError, match="dual-feasible"):
        jdual.solve_dual(A, b, c)
    # unchecked, the loop runs (and must not claim a wrong optimum)
    res = solve_dual(A, b, c, check_entry=False, device="cpu")
    assert res.status != SolveStatus.OPTIMAL or res.feas_err < 1e-5


def test_entry_check_is_f64_and_skips_fixed_columns():
    A, b, c = random_dense_lp(12, 30, seed=4)
    cold = solve(A, b, c, device="cpu")
    got = dual._entry_dual_feasibility(A, c, cold.basis, None, None, torch.device("cpu"))
    want = jdual._entry_dual_feasibility(A, c, cold.basis, None, None, JaxOptions())
    assert abs(got - want) < 1e-9 and got > -1e-4
    # a fixed column with a wildly improving cost is not counted
    u = np.full(30, np.inf)
    j = int(np.setdiff1d(np.arange(30), cold.basis)[0])
    u[j] = 0.0
    c2 = c.copy()
    c2[j] = 1e3
    assert dual._entry_dual_feasibility(A, c2, cold.basis, np.zeros(30, bool), u, torch.device("cpu")) > -1e-4
    assert dual._entry_dual_feasibility(A, c2, cold.basis, None, None, torch.device("cpu")) < -1.0
    # a singular entry basis is rejected, not raised
    assert dual._entry_dual_feasibility(A, c, np.zeros(12, np.int32), None, None, torch.device("cpu")) == -np.inf


def test_solve_dual_option_rules_and_device():
    A, b, c = random_dense_lp(8, 20, seed=0)
    with pytest.raises(NotImplementedError, match="multi_price"):
        solve_dual(A, b, c, options=SimplexOptions(pricing="steepest", multi_price=4), device="cpu")
    if not torch.cuda.is_available():
        cold = solve(A, b, c, device="cpu")
        with pytest.raises((RuntimeError, AssertionError)):
            solve_dual(A, b, c, basis0=cold.basis)
        with pytest.raises((RuntimeError, AssertionError)):
            reoptimize(A, b, c, cold)


# --------------------------------------------------------------------------
# solve_general(warm=)
# --------------------------------------------------------------------------


def test_solve_general_warm_restart_matches_jax_and_highs():
    lp = multiperiod_production_lp(4, 3, seed=5)  # E rows, L rows, bounds
    opts = SimplexOptions(**OPTS)
    cold = solve_general(GeneralLP(*lp), options=opts, device="cpu")
    assert cold.status == SolveStatus.OPTIMAL and cold.warm is not None
    rng = np.random.default_rng(41)
    lp2 = lp._replace(b=lp.b * (1 + 0.1 * rng.uniform(-1, 1, lp.b.shape)))
    ref = solve_scipy_general(lp2)
    cold2 = solve_general(GeneralLP(*lp2), options=opts, device="cpu")
    warm2 = solve_general(GeneralLP(*lp2), options=opts, warm=cold.warm, device="cpu")
    jcold = jax_solve_general(JaxGeneralLP(*lp), options=JaxOptions(**OPTS))
    jwarm2 = jax_solve_general(JaxGeneralLP(*lp2), options=JaxOptions(**OPTS), warm=jcold.warm)
    assert warm2.status == SolveStatus.OPTIMAL == ref.status == int(jwarm2.status)
    assert relative_gap(warm2.z, ref.z) < 1e-4 and relative_gap(warm2.z, jwarm2.z) < 1e-4
    assert warm2.phase1_iters == 0
    assert warm2.iters < cold2.iters, (warm2.iters, cold2.iters)
    assert warm2.warm is not None  # a warm result can be chained


def test_solve_general_warm_restart_sign_flip():
    # a b that crosses zero changes which rows a cold standardization would
    # flip; the token pins the original flips
    lp = GeneralLP(
        A=np.array([[1.0, 1.0], [1.0, -2.0]]), b=np.array([4.0, 1.0]),
        c=np.array([-1.0, -2.0]), row_types=["L", "L"],
    )
    cold = solve_general(lp, device="cpu")
    lp2 = lp._replace(b=np.array([4.0, -1.0]))
    ref = solve_scipy_general(lp2)
    warm = solve_general(lp2, warm=cold.warm, device="cpu")
    assert warm.status == ref.status == SolveStatus.OPTIMAL
    assert relative_gap(warm.z, ref.z) < 1e-5


def test_solve_general_warm_infeasible():
    lp = GeneralLP(
        A=np.array([[1.0, 1.0]]), b=np.array([2.0]), c=np.array([-1.0, -1.0]),
        row_types=["E"], upper=np.array([1.5, 1.5]), lower=np.zeros(2),
    )
    cold = solve_general(lp, device="cpu")
    assert cold.status == SolveStatus.OPTIMAL
    # x1 + x2 = 4 is impossible with u = 1.5 each
    warm = solve_general(lp._replace(b=np.array([4.0])), warm=cold.warm, device="cpu")
    assert warm.status == SolveStatus.INFEASIBLE


def test_solve_general_warm_rejects_presolve_and_foreign_tokens():
    lp = multiperiod_production_lp(4, 3, seed=5)
    cold = solve_general(GeneralLP(*lp), device="cpu")
    with pytest.raises(ValueError, match="presolve"):
        solve_general(GeneralLP(*lp), warm=cold.warm, presolve=True, device="cpu")
    other = multiperiod_production_lp(3, 3, seed=5)
    with pytest.raises(ValueError, match="warm token"):
        solve_general(GeneralLP(*other), warm=cold.warm, device="cpu")


def test_warm_restart_on_an_unchanged_b_matches_jax():
    # a basis the Harris ratio test left primal infeasible beyond the dual
    # loop's exit test (the cold solve runs with a loose feas_tol of 1e-3),
    # re-solved on the SAME b under the default options: both packages take
    # the same pivots to the same optimum (the reference behaves the same)
    A, b, c = (v.astype(np.float32) for v in random_dense_lp(48, 128, seed=0))
    cold = solve(A, b, c, options=SimplexOptions(feas_tol=1e-3), device="cpu")
    jcold = simplex_tpu.solve(A, b, c, options=JaxOptions(feas_tol=1e-3))
    assert cold.status == SolveStatus.OPTIMAL == int(jcold.status)
    assert cold.iters == jcold.iters
    np.testing.assert_array_equal(cold.basis, np.asarray(jcold.basis))
    assert cold.feas_err > 1e-4 and jcold.feas_err > 1e-4
    warm = reoptimize(A, b, c, cold, device="cpu")
    jwarm = jax_reoptimize(A, b, c, jcold)
    assert warm.status == SolveStatus.OPTIMAL == int(jwarm.status)
    assert warm.iters == jwarm.iters >= 1
    assert relative_gap(warm.z, jwarm.z) <= 1e-5 and warm.feas_err < 1e-5
