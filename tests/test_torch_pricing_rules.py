"""Devex and steepest-edge pricing of the port against the JAX package's:
the four ops against ``simplex_tpu.kernels.xla``, one pivot step from the
same JAX state (eager, deferred, bounded), a stale pick that must take the
exact pass, and whole solves against ``simplex_tpu.solve`` and HiGHS.

States carry across with ``state_from_numpy`` (e and gamma included).
Mirrors the single-device cases of ``tests/test_devex.py`` and
``tests/test_steepest.py``.

Tolerances: indices, flags and counts exactly; e, gamma and the other
float leaves to rtol 1e-5 (atol 1e-5) after one step (fp32 products that
sum in another order); z to rel gap 1e-5 in fp32 (the fp32 gate; 1e-4 with
``refactor_every``, as the JAX test of the same case allows) and 1e-9 in
f64. Pivot paths are compared only on tie-free instances (sample.txt, the
Klee-Minty cube).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import simplex_tpu
from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.core import step as jstep
from simplex_tpu.core.state import Problem as JaxProblem
from simplex_tpu.core.state import initial_state as jax_initial
from simplex_tpu.core.state import initial_state_slack as jax_slack
from simplex_tpu.kernels import xla as jxla
from simplex_tpu.kernels.dispatch import get_backend as jax_backend
from simplex_tpu.oracle.generator import klee_minty_lp, random_dense_lp
from simplex_tpu.oracle.reference import relative_gap, solve_scipy
from simplex_tpu_torch import SimplexOptions, SolveStatus, load_lp, solve
from simplex_tpu_torch.core import step
from simplex_tpu_torch.core.state import (
    initial_state,
    initial_state_slack,
    problem_from_numpy,
    state_from_numpy,
)
from simplex_tpu_torch.kernels import dispatch, hopper, ops

JB = jax_backend("xla")
JSTEP = jax.jit(lambda p, s, o: jstep.pivot_step(p, s, o, JB), static_argnums=2)
RULES = ["devex", "steepest"]
SAMPLE = "tests/data/sample.txt"


def f32(*vs):
    return [np.asarray(v, np.float32) for v in vs]


def leaves(s, defer=False):
    """A JAX SolverState's leaves as host arrays, e and gamma included."""
    names = ["B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen",
             "last_refac", "e", "gamma"]
    if defer:
        names += ["U", "R", "npend"]
    d = {f: np.asarray(getattr(s, f)) for f in names}
    d["at_upper"] = None if s.at_upper is None else np.asarray(s.at_upper)
    d["pert"] = None if s.pert is None else tuple(np.asarray(v) for v in s.pert)
    return d


def close(t, j, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=what)


def assert_same(ts, js, defer=False, buffers=True):
    """Leaf for leaf. ``buffers=False`` compares the true inverse
    B_inv + U.T R in place of B_inv, U, R and npend: on a bound flip at
    npend = L - 1 the port flushes (its flush is decided on the host) where
    the JAX step keeps the pairs pending; the true inverse is the same."""
    np.testing.assert_array_equal(ts.basis.numpy(), np.asarray(js.basis))
    for f in ("status", "iters", "degen"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    floats = ["B_inv", "x_b", "y", "c_b", "e", "gamma"]
    if defer and buffers:
        assert int(ts.npend) == int(js.npend)
        floats += ["U", "R"]
    elif defer:
        floats.remove("B_inv")
        close(ts.B_inv + ts.U.T @ ts.R, js.B_inv + js.U.T @ js.R, "B_inv + U.T R")
    for f in floats:
        close(getattr(ts, f), getattr(js, f), f)
    if js.at_upper is not None:
        np.testing.assert_array_equal(ts.at_upper.numpy(), np.asarray(js.at_upper))


def problems(A, b, c, u=None):
    A, b, c = f32(A, b, c)
    ju = None if u is None else jnp.asarray(np.asarray(u, np.float32))
    jp = JaxProblem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), u=ju)
    return jp, problem_from_numpy(A, b, c, "cpu", u=u)


def walk(jp, jopts, k):
    """The JAX state after k pivot steps with ``jopts`` from the slack basis."""
    js = jax_slack(
        jp, jnp.float32, pricing=jopts.pricing, update_defer=jopts.resolve_defer(),
        perturb=True,
    )
    for _ in range(k):
        js = JSTEP(jp, js, jopts)
    return js


def random_bounded(seed, m, k, frac_bounded=0.7):
    """max c.x s.t. [A0 | I] x = b, 0 <= x <= u, slack basis feasible
    (``tests/test_bounded_native.py``'s instances)."""
    rng = np.random.default_rng(seed)
    A0 = rng.uniform(0.1, 1.0, size=(m, k))
    b = rng.uniform(m * 0.5, m * 1.5, size=m)
    c0 = rng.uniform(0.1, 1.0, size=k)
    u0 = np.where(rng.uniform(size=k) < frac_bounded, rng.uniform(0.2, 3.0, size=k), np.inf)
    A = np.concatenate([A0, np.eye(m)], axis=1)
    return A, b, np.concatenate([c0, np.zeros(m)]), np.concatenate([u0, np.full(m, np.inf)])


# --------------------------------------------------------------------------
# the four ops against kernels/xla.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bland", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_devex_choose_matches_xla(bland, seed):
    # continuous random scores: no ties
    rng = np.random.default_rng(seed)
    n = 200
    e, gamma = f32(rng.standard_normal(n), rng.uniform(1.0, 50.0, n))
    pj, mj = jxla.devex_choose(jnp.asarray(e), jnp.asarray(gamma), 1e-5, jnp.asarray(bland))
    pt, mt = ops.devex_choose(torch.from_numpy(e), torch.from_numpy(gamma), 1e-5, torch.tensor(bland))
    assert pt.dtype == torch.int32 and int(pt) == int(pj)
    assert float(mt) == float(mj)


def test_devex_choose_ties_break_to_the_lowest_index():
    # explicit ties: equal scores at 3 and 7, and no eligible column at all
    e = np.zeros(12, np.float32)
    e[[3, 7]] = -2.0
    gamma = np.ones(12, np.float32)
    for bland in (False, True):
        pj, _ = jxla.devex_choose(jnp.asarray(e), jnp.asarray(gamma), 1e-5, jnp.asarray(bland))
        pt, _ = ops.devex_choose(torch.from_numpy(e), torch.from_numpy(gamma), 1e-5, torch.tensor(bland))
        assert int(pt) == int(pj) == 3
    none = np.ones(12, np.float32)
    pj, mj = jxla.devex_choose(jnp.asarray(none), jnp.asarray(gamma), 1e-5, jnp.asarray(False))
    pt, mt = ops.devex_choose(torch.from_numpy(none), torch.from_numpy(gamma), 1e-5, torch.tensor(False))
    assert int(pt) == int(pj) == 0 and float(mt) == float(mj) == 1.0


@pytest.mark.parametrize("bland", [False, True])
@pytest.mark.parametrize("frac_up", [0.0, 0.4, 1.0])
def test_devex_choose_bounded_matches_xla(bland, frac_up):
    rng = np.random.default_rng(5)
    n = 200
    e, gamma = f32(rng.standard_normal(n), rng.uniform(1.0, 50.0, n))
    up = rng.uniform(size=n) < frac_up
    pj, mj = jxla.devex_choose_bounded(
        jnp.asarray(e), jnp.asarray(gamma), jnp.asarray(up), 1e-5, jnp.asarray(bland)
    )
    pt, mt = ops.devex_choose_bounded(
        torch.from_numpy(e), torch.from_numpy(gamma), torch.from_numpy(up), 1e-5, torch.tensor(bland)
    )
    assert pt.dtype == torch.int32 and int(pt) == int(pj)
    assert float(mt) == float(mj)


@pytest.mark.parametrize("m,n", [(24, 60), (48, 120)])
def test_pricing_updates_match_xla(m, n):
    # rtol 1e-5: fp32 sums of m terms in another order
    rng = np.random.default_rng(m)
    A, rho, u = f32(rng.standard_normal((m, n)), rng.standard_normal(m), rng.standard_normal(m))
    wj = jxla.pricing_update(jnp.asarray(A), jnp.asarray(rho))
    w2j, v2j = jxla.pricing_update2(jnp.asarray(A), jnp.asarray(rho), jnp.asarray(u))
    At, rt, ut = map(torch.from_numpy, (A, rho, u))
    close(ops.pricing_update(At, rt), wj, "w", atol=1e-5)
    w2, v2 = ops.pricing_update2(At, rt, ut)
    close(w2, w2j, "w (stacked)")
    close(v2, v2j, "v (stacked)")
    # one pass equals two
    close(v2, np.asarray(jxla.pricing_update(jnp.asarray(A), jnp.asarray(u))), "v")


def test_both_backends_expose_the_pricing_ops():
    for name in dispatch.BACKENDS:
        be = dispatch.get_backend(name)
        assert be.devex_choose is ops.devex_choose
        assert be.devex_choose_bounded is ops.devex_choose_bounded
        assert be.pricing_update is ops.pricing_update
        assert be.pricing_update2 is ops.pricing_update2


# --------------------------------------------------------------------------
# the initial e and gamma
# --------------------------------------------------------------------------


@pytest.mark.parametrize("rule", RULES)
def test_initial_extras_match_jax(rule):
    A, b, c = random_dense_lp(16, 40, seed=2)
    jp, tp = problems(A, b, c)
    js = jax_slack(jp, jnp.float32, pricing=rule)
    ts = initial_state_slack(tp, torch.float32, pricing=rule)
    close(ts.e, js.e, "e")
    close(ts.gamma, js.gamma, "gamma")
    # from a given basis: steepest edge takes the norms of B_inv A
    basis = np.asarray(simplex_tpu.solve(A, b, c).basis)
    js = jax_initial(jp, basis, jnp.float32, pricing=rule)
    ts = initial_state(tp, basis, torch.float32, pricing=rule)
    close(ts.e, js.e, "e", atol=1e-4)
    close(ts.gamma, js.gamma, "gamma", rtol=1e-4)
    assert initial_state_slack(tp, torch.float32).e is None


# --------------------------------------------------------------------------
# one step from the same JAX state
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("k", [0, 1, 4, 9])
def test_eager_step_matches_jax(backend, rule, k):
    jp, tp = problems(*random_dense_lp(32, 80, seed=1))
    jopts = JaxOptions(pricing=rule)
    js = walk(jp, jopts, k)
    assert int(js.status) == SolveStatus.RUNNING
    ts = state_from_numpy(leaves(js), "cpu")
    js1 = JSTEP(jp, js, jopts)
    ts1 = step.pivot_step(tp, ts, SimplexOptions(pricing=rule, backend=backend), dispatch.get_backend(backend))
    assert int(ts1.iters) == k + 1
    assert_same(ts1, js1)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("k", [0, 2, 3, 7])
def test_deferred_step_matches_jax(rule, k):
    # k = 3 and 7 leave 3 pairs pending: the step appends the fourth and
    # flushes; steepest's u reads the base plus the pending pairs
    L = 4
    jp, tp = problems(*random_dense_lp(32, 80, seed=1))
    jopts = JaxOptions(pricing=rule, update_defer=L)
    js = walk(jp, jopts, k)
    assert int(js.status) == SolveStatus.RUNNING and int(js.npend) == k % L
    ts = state_from_numpy(leaves(js, defer=True), "cpu")
    js1 = JSTEP(jp, js, jopts)
    ts1 = step.pivot_step(
        tp, ts, SimplexOptions(pricing=rule, update_defer=L), dispatch.get_backend("hopper")
    )
    assert_same(ts1, js1, defer=True)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("defer", [0, 4])
@pytest.mark.parametrize("k", [0, 3, 6, 11])
def test_bounded_step_matches_jax(rule, defer, k):
    # pivots and bound flips: a flip changes neither e nor gamma
    A, b, c, u = random_bounded(2, 20, 50)
    jp, tp = problems(A, b, c, u)
    jopts = JaxOptions(pricing=rule, update_defer=defer)
    js = walk(jp, jopts, k)
    assert int(js.status) == SolveStatus.RUNNING
    ts = state_from_numpy(leaves(js, defer=defer > 0), "cpu")
    js1 = JSTEP(jp, js, jopts)
    ts1 = step.pivot_step(
        tp, ts, SimplexOptions(pricing=rule, update_defer=defer), dispatch.get_backend("hopper")
    )
    assert_same(ts1, js1, defer=defer > 0, buffers=False)


@pytest.mark.parametrize("rule", RULES)
def test_bounded_walk_sees_a_flip(rule):
    # the walk of the test above contains at least one bound flip, so the
    # do_pivot gate of the e / gamma update is exercised
    A, b, c, u = random_bounded(2, 20, 50)
    jp, tp = problems(A, b, c, u)
    ts = initial_state_slack(tp, torch.float32, pricing=rule)
    opts = SimplexOptions(pricing=rule)
    be = dispatch.get_backend("torch")
    flips = 0
    for _ in range(20):
        before = ts
        ts = step.pivot_step(tp, ts, opts, be)
        if int(ts.status) != SolveStatus.RUNNING:
            break
        if torch.equal(ts.basis, before.basis):
            flips += 1
            assert torch.equal(ts.e, before.e) and torch.equal(ts.gamma, before.gamma)
    assert flips >= 1


@pytest.mark.parametrize("rule", RULES)
def test_terminal_step_changes_nothing(rule):
    A, b, c = random_dense_lp(12, 30, seed=4)
    jp, tp = problems(A, b, c)
    res = simplex_tpu.solve(A, b, c)
    ts = initial_state(tp, np.asarray(res.basis), torch.float32, pricing=rule)
    e0, g0 = ts.e.clone(), ts.gamma.clone()
    ts1 = step.pivot_step(tp, ts, SimplexOptions(pricing=rule), dispatch.get_backend("hopper"))
    assert int(ts1.status) == SolveStatus.OPTIMAL and int(ts1.iters) == 0
    assert torch.equal(ts1.e, e0) and torch.equal(ts1.gamma, g0)


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("how", ["drifted e", "basic pick", "bland"])
def test_stale_pick_takes_the_exact_pass(monkeypatch, rule, bounded, how):
    # a maintained e that disagrees with y: the incremental pick is stale
    # (its exact reduced cost does not improve, or it is already basic), so
    # both packages fall back to one exact pricing pass and agree on it
    if bounded:
        A, b, c, u = random_bounded(2, 20, 50)
    else:
        (A, b, c), u = random_dense_lp(12, 36, seed=7), None
    jp, tp = problems(A, b, c, u)
    jopts = JaxOptions(pricing=rule, bland_after=5)
    js = walk(jp, jopts, 3)
    e = np.asarray(js.e).copy()
    if how == "drifted e":
        j = int(np.argmax(np.asarray(js.e)))  # a column that does not improve
        if bounded:
            j = int(np.argmax(np.where(np.asarray(js.at_upper), -np.inf, np.asarray(js.e))))
        e[j] = -1e3
    elif how == "basic pick":
        e[int(np.asarray(js.basis)[0])] = -1e3
    else:
        js = js._replace(degen=jnp.int32(5))
    js = js._replace(e=jnp.asarray(e))
    ts = state_from_numpy(leaves(js), "cpu")
    calls = []
    name = "choose_entering_bounded" if bounded else "choose_entering"
    inner = getattr(hopper, name)
    monkeypatch.setattr(hopper, name, lambda *a, **k: calls.append(1) or inner(*a, **k))
    step.reset_host_reads()
    topts = SimplexOptions(pricing=rule, bland_after=5)
    be = dispatch.get_backend("hopper")
    ctl = step.read_control(ts, topts, tp, be)
    assert ctl.stale == (how != "bland")  # under Bland the host skips the pick
    ts1 = step.pivot_step(tp, ts, topts, be, ctl)
    js1 = JSTEP(jp, js, jopts)
    assert calls == [1]
    # the flag rode on the control read: no read of its own
    assert step.host_reads == {"control": 1, "branch": 0}
    np.testing.assert_array_equal(ts1.basis.numpy(), np.asarray(js1.basis))
    for f in ("x_b", "y"):
        close(getattr(ts1, f), getattr(js1, f), f)
    assert int(ts1.iters) == int(js1.iters) == 4


@pytest.mark.parametrize("rule", RULES)
def test_fresh_pick_skips_the_exact_pass(monkeypatch, rule):
    jp, tp = problems(*random_dense_lp(32, 80, seed=1))
    js = walk(jp, JaxOptions(pricing=rule), 2)
    ts = state_from_numpy(leaves(js), "cpu")
    monkeypatch.setattr(hopper, "choose_entering", lambda *a, **k: pytest.fail("exact pass"))
    step.reset_host_reads()
    # no control given: the step reads it (with the pick) itself
    ts1 = step.pivot_step(tp, ts, SimplexOptions(pricing=rule), dispatch.get_backend("hopper"))
    assert int(ts1.iters) == 3
    assert step.host_reads == {"control": 1, "branch": 0}
    # a control read without the problem carries no pick: refused
    ts = state_from_numpy(leaves(js), "cpu")
    opts = SimplexOptions(pricing=rule)
    with pytest.raises(ValueError, match="no pick"):
        step.pivot_step(tp, ts, opts, dispatch.get_backend("hopper"), step.read_control(ts, opts))


@pytest.mark.parametrize("defer", [0, 4])
def test_weights_are_exact_norms_every_pivot(defer):
    # gamma_j == 1 + |B_inv A_j|^2 for every nonbasic j after every pivot
    # (f64, rtol 1e-8; tests/test_steepest.py's pin of exact steepest edge)
    A, b, c = random_dense_lp(12, 30, seed=5, dtype=np.float64)
    tp = problem_from_numpy(A, b, c, "cpu", torch.float64)
    opts = SimplexOptions(pricing="steepest", dtype=torch.float64, update_defer=defer, backend="torch")
    ts = initial_state_slack(tp, torch.float64, update_defer=defer, pricing="steepest")
    be = dispatch.get_backend("torch")
    for _ in range(12):
        ts = step.pivot_step(tp, ts, opts, be)
        if int(ts.status) != SolveStatus.RUNNING:
            break
        basis = ts.basis.numpy()
        T = np.linalg.solve(A[:, basis], A)
        nonbasic = np.ones(A.shape[1], bool)
        nonbasic[basis] = False
        np.testing.assert_allclose(
            ts.gamma.numpy()[nonbasic], (1 + np.sum(T * T, axis=0))[nonbasic], rtol=1e-8,
            err_msg=f"after pivot {int(ts.iters)}",
        )
    assert int(ts.iters) >= 3


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("defer", [False, True])
def test_refactorize_matches_jax(rule, defer):
    # e re-derived exactly; devex resets gamma to 1, steepest keeps it
    L = 4 if defer else 0
    jp, tp = problems(*random_dense_lp(32, 80, seed=1))
    js = walk(jp, JaxOptions(pricing=rule, update_defer=L), 6)
    ts = state_from_numpy(leaves(js, defer), "cpu")
    js1 = jstep.refactorize(jp, js, JB, pricing=rule, defer=defer)
    ts1 = step.refactorize(tp, ts, dispatch.get_backend("hopper"), defer, rule)
    for f in ("B_inv", "x_b", "y", "e", "gamma"):
        close(getattr(ts1, f), getattr(js1, f), f, atol=2e-5)
    if rule == "devex":
        assert torch.equal(ts1.gamma, torch.ones(80))
    assert int(ts1.last_refac) == 6


# --------------------------------------------------------------------------
# whole solves
# --------------------------------------------------------------------------


def check_solve(A, b, c, tol=1e-5, dtype=torch.float32, u=None, **opts):
    """The port's solve against simplex_tpu.solve and HiGHS, same options."""
    res = solve(A, b, c, u=u, options=SimplexOptions(dtype=dtype, **opts), device="cpu")
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    opts.pop("backend", None)  # the port's op set; JAX keeps its default
    ref_jax = simplex_tpu.solve(A, b, c, u=u, options=JaxOptions(dtype=jdtype, **opts))
    assert res.status == SolveStatus.OPTIMAL == int(ref_jax.status)
    assert relative_gap(res.z, ref_jax.z) <= tol
    assert res.feas_err <= 1e-5
    return res, ref_jax


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("m,n,seed", [(8, 20, 0), (32, 80, 1), (96, 240, 2)])
def test_solve_f64_matches_oracle(rule, m, n, seed):
    A, b, c = random_dense_lp(m, n, seed=seed, dtype=np.float64)
    res, _ = check_solve(A, b, c, tol=1e-9, dtype=torch.float64, pricing=rule, backend="torch")
    assert relative_gap(res.z, solve_scipy(A, b, c).z) < 1e-9


@pytest.mark.parametrize("backend", ["hopper", "torch"])
@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("defer", [0, 4])
def test_solve_fp32_matches_jax_and_highs(backend, rule, defer):
    A, b, c = random_dense_lp(48, 120, seed=9)
    res, _ = check_solve(A, b, c, pricing=rule, update_defer=defer, backend=backend)
    assert relative_gap(res.z, solve_scipy(A, b, c).z) <= 1e-5


@pytest.mark.parametrize("rule", RULES)
def test_solve_fp32_with_refactor(rule):
    A, b, c = random_dense_lp(128, 320, seed=3)
    res, _ = check_solve(A, b, c, tol=1e-4, pricing=rule, refactor_every=64)
    assert relative_gap(res.z, solve_scipy(A, b, c).z) < 1e-4


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("defer", [0, 4])
def test_solve_bounded_matches_jax_and_highs(rule, defer):
    import scipy.optimize as sopt

    A, b, c, u = random_bounded(3, 16, 40)
    res, _ = check_solve(A, b, c, u=u, pricing=rule, update_defer=defer)
    bounds = [(0.0, x if np.isfinite(x) else None) for x in u]
    ref = sopt.linprog(-c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
    assert ref.status == 0 and relative_gap(res.z, -ref.fun) <= 1e-5


@pytest.mark.parametrize("rule", RULES)
def test_pivot_path_on_sample(rule):
    A, b, c = load_lp(SAMPLE)
    res, ref = check_solve(A, b, c, pricing=rule)
    assert abs(res.z - 9.0) < 1e-5
    assert res.iters == int(ref.iters)
    np.testing.assert_array_equal(np.sort(res.basis), np.sort(np.asarray(ref.basis)))


@pytest.mark.parametrize("rule", RULES)
def test_pivot_path_on_klee_minty(rule):
    A, b, c = klee_minty_lp(6)
    res, ref = check_solve(A, b, c, tol=1e-9, dtype=torch.float64, pricing=rule, backend="torch")
    assert abs(res.z - 15625.0) < 1e-6
    assert res.iters == int(ref.iters)
    np.testing.assert_array_equal(res.basis, np.asarray(ref.basis))


@pytest.mark.parametrize("rule", RULES)
def test_unbounded_and_already_optimal(rule):
    opts = SimplexOptions(pricing=rule, dtype=torch.float64, backend="torch")
    res = solve([[-1.0, 1.0, 1.0]], [1.0], [1.0, 0.0, 0.0], options=opts, device="cpu")
    assert res.status == SolveStatus.UNBOUNDED
    res = solve(
        np.hstack([np.eye(3), np.eye(3)]), np.ones(3), np.r_[-np.ones(3), np.zeros(3)],
        options=opts, device="cpu",
    )
    assert res.status == SolveStatus.OPTIMAL and res.iters == 0 and abs(res.z) < 1e-12


def test_steepest_takes_no_more_pivots_than_dantzig_on_average():
    # tests/test_steepest.py's path-length check, on the port alone
    it = {"dantzig": 0, "steepest": 0}
    for seed in range(4):
        A, b, c = random_dense_lp(32, 80, seed=seed, dtype=np.float64)
        for rule in it:
            opts = SimplexOptions(pricing=rule, dtype=torch.float64, backend="torch")
            it[rule] += solve(A, b, c, options=opts, device="cpu").iters
    assert it["steepest"] <= it["dantzig"]


def test_option_rules():
    A, b, c = random_dense_lp(8, 20, seed=0)
    with pytest.raises(NotImplementedError, match="multi_price"):
        solve(A, b, c, options=SimplexOptions(pricing="steepest", multi_price=4), device="cpu")
    with pytest.raises(ValueError, match="pricing rule"):
        solve(A, b, c, options=SimplexOptions(pricing="dantzig2"), device="cpu")
    # devex drops multi_price (with a warning) and solves
    res = solve(A, b, c, options=SimplexOptions(pricing="devex", multi_price=4), device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    # the shadow and the segments stay off under the weighted rules
    opts = SimplexOptions(pricing="steepest", pricing_dtype="bfloat16", partial_pricing=2, partial_min_segment=4)
    res = solve(A, b, c, options=opts, device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    assert relative_gap(res.z, solve_scipy(A, b, c).z) <= 1e-5


def test_default_device_has_no_cpu_fallback():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    A, b, c = random_dense_lp(8, 20, seed=0)
    with pytest.raises((RuntimeError, AssertionError)):
        solve(A, b, c, options=SimplexOptions(pricing="steepest"))
