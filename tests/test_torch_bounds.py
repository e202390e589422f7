"""The port's bounded-variable rule (``solve(u=)``) against the JAX
package's: the two bounded ops, one pivot step from the same state, the
bounded perturbation, and whole solves against ``simplex_tpu.solve`` and
HiGHS.

States carry across with ``state_from_numpy`` (``at_upper`` included).
Pivot steps are compared on the tie-free instances of
``tests/test_bounded_native.py`` (a bound flip, a basic variable leaving at
its upper bound, a column entering from its upper bound) and on a
pivot-then-flip instance under deferred updates. Inputs are numpy-seeded
and float32 in both packages.

Tolerances: indices, flags and counts exactly; op values to rtol 1e-6
(fp32 reductions in another order); state vectors after one step to rtol /
atol 1e-5; z to rel gap 1e-5 against HiGHS and the JAX package (the fp32
gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.optimize as sopt
import torch

import simplex_tpu
from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.core import step as jstep
from simplex_tpu.core.state import Problem as JaxProblem
from simplex_tpu.core.state import initial_state_slack as jax_slack
from simplex_tpu.kernels import xla as jxla
from simplex_tpu.kernels.dispatch import get_backend as jax_backend
from simplex_tpu_torch import SimplexOptions, SolveStatus, solve
from simplex_tpu_torch.core import solver, step
from simplex_tpu_torch.core.state import problem_from_numpy, state_from_numpy
from simplex_tpu_torch.kernels import dispatch, hopper, ops

JB = jax_backend("xla")
# one trace per (shape, options)
JSTEP = jax.jit(lambda p, s, o: jstep.pivot_step(p, s, o, JB), static_argnums=2)
GAP = 1e-5

# (A, b, c, u, at_upper0) of tests/test_bounded_native.py:74-120, tie-free
ALL_FLIPS = ([[1.0, 1.0, 1.0]], [4.0], [1.0, 2.0, 0.0], [1.0, 3.0, np.inf], None)
LEAVE_UPPER = (
    [[-1.0, 1.0, 0.0], [1.0, 0.0, 1.0]], [1.0, 4.0], [1.0, 0.0, 0.0],
    [np.inf, 2.0, np.inf], None,
)
FROM_UPPER = (
    [[1.0, 1.0, 1.0]], [2.0], [-2.0, 1.0, 0.0], [1.5, 1.0, np.inf],
    [True, False, False],
)
# a pivot (x0 enters, s0 leaves) and then a flip (x1 to its bound 0.5)
PIVOT_THEN_FLIP = (
    [[1.0, 0.0, 1.0, 0.0], [0.0, 1.0, 0.0, 1.0]], [1.0, 4.0], [3.0, 1.0, 0.0, 0.0],
    [np.inf, 0.5, np.inf, np.inf], None,
)


def f32(*vs):
    return [np.asarray(v, np.float32) for v in vs]


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


def highs(A, b, c, u):
    bounds = [(0.0, x if np.isfinite(x) else None) for x in u]
    res = sopt.linprog(-np.asarray(c), A_eq=A, b_eq=b, bounds=bounds, method="highs")
    assert res.status == 0
    return -res.fun


def rel(a, b):
    return abs(a - b) / max(1.0, abs(b))


# --------------------------------------------------------------------------
# the two bounded ops against kernels/xla.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("base_col,w", [(0, 60), (20, 20)])
@pytest.mark.parametrize("bland", [False, True])
@pytest.mark.parametrize("frac_up", [0.0, 0.4])
def test_choose_entering_bounded_matches_xla(base_col, w, bland, frac_up):
    rng = np.random.default_rng(11)
    m, n = 24, 60
    y, A, c = f32(rng.standard_normal(m), rng.standard_normal((m, n)), rng.standard_normal(n))
    at_up = rng.uniform(size=n) < frac_up
    basis = rng.choice(n, m, replace=False).astype(np.int32)
    sl = slice(base_col, base_col + w)
    args = (A[:, sl], c[sl], at_up[sl], basis)
    pj, sj = jxla.choose_entering_bounded(
        jnp.asarray(y), *map(jnp.asarray, args), jnp.int32(base_col), 1e-5, jnp.asarray(bland)
    )
    pt, st = ops.choose_entering_bounded(
        torch.from_numpy(y), *map(torch.from_numpy, args), base_col, 1e-5,
        torch.tensor(bland),
    )
    assert int(pt) == int(pj) + base_col  # the port returns the global column
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-6)


@pytest.mark.parametrize("harris", [True, False])
@pytest.mark.parametrize("bland", [False, True])
@pytest.mark.parametrize("case", ["mixed", "flip", "unbounded", "degenerate"])
def test_ratio_argmin_bounded_matches_xla(harris, bland, case):
    rng = np.random.default_rng({"mixed": 1, "flip": 2, "unbounded": 3, "degenerate": 4}[case])
    m = 32
    x_b = rng.uniform(0.0, 2.0, m)
    d = rng.standard_normal(m)
    u_basic = np.where(rng.uniform(size=m) < 0.5, x_b + rng.uniform(0.1, 2.0, m), np.inf)
    u_p = 1.5
    if case == "flip":
        u_p = 1e-3  # the entering column reaches its own bound first
    elif case == "unbounded":
        d = -np.abs(d)
        u_basic[:] = np.inf
        u_p = np.inf
    elif case == "degenerate":
        x_b[::5] = 0.0  # exact theta = 0 ties
    x_b, d, u_basic = f32(x_b, d, u_basic)
    u_p = np.float32(u_p)
    basis = rng.permutation(m).astype(np.int32)
    outj = jxla.ratio_argmin_bounded(
        jnp.asarray(x_b), jnp.asarray(d), jnp.asarray(u_basic), jnp.asarray(u_p),
        jnp.asarray(basis), 1e-7, jnp.asarray(bland), harris, 1e-6,
    )
    outt = ops.ratio_argmin_bounded(
        torch.from_numpy(x_b), torch.from_numpy(d), torch.from_numpy(u_basic),
        torch.tensor(u_p), torch.from_numpy(basis), 1e-7, torch.tensor(bland), harris, 1e-6,
    )
    qj, thj, unbj, flj, luj = (np.asarray(v) for v in outj)
    qt, tht, unbt, flt, lut = (v.numpy() for v in outt)
    assert (bool(unbt), bool(flt)) == (bool(unbj), bool(flj))
    assert bool(unbt) == (case == "unbounded")
    if case == "flip":
        assert bool(flt)
    if not (bool(unbt) or bool(flt)):
        assert int(qt) == int(qj) and bool(lut) == bool(luj)
    np.testing.assert_allclose(tht, thj, rtol=1e-6)


def test_both_backends_take_the_plain_bounded_ops():
    # the two-sided ratio test is the plain op on both backends; the signed
    # pricing is pricing_scan's signed mode on the hopper backend, which on
    # CPU tensors is its plain version
    for name in ("hopper", "torch"):
        be = dispatch.get_backend(name)
        assert be.ratio_argmin_bounded is ops.ratio_argmin_bounded
    assert dispatch.get_backend("torch").choose_entering_bounded is ops.choose_entering_bounded
    assert dispatch.get_backend("hopper").choose_entering_bounded is hopper.choose_entering_bounded


@pytest.mark.parametrize("base_col,w", [(0, 64), (16, 16), (48, 16)])
@pytest.mark.parametrize("bland", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_hopper_bounded_pricing_matches_plain_and_xla(base_col, w, bland, dtype):
    # the hopper backend's signed pricing (on CPU tensors: pricing_scan's
    # plain signed mode) against ops.choose_entering_bounded and, in fp32,
    # kernels/xla.py; on a segment view of A in place, at-upper columns and
    # basic columns (penalized) inside the segment
    rng = np.random.default_rng(12 + base_col)
    m, n = 24, 64
    y, A, c = f32(rng.standard_normal(m), rng.standard_normal((m, n)), rng.standard_normal(n))
    at_up = rng.uniform(size=n) < 0.4
    basis = rng.choice(n, m, replace=False).astype(np.int32)
    sl = slice(base_col, base_col + w)
    At = torch.from_numpy(A).to(dtype)
    args = (torch.from_numpy(c[sl]), torch.from_numpy(at_up[sl]), torch.from_numpy(basis))
    flag = torch.tensor(bland)
    pk, sk = hopper.choose_entering_bounded(torch.from_numpy(y), At[:, sl], *args, base_col, 1e-5, flag)
    pp, sp = ops.choose_entering_bounded(torch.from_numpy(y), At[:, sl], *args, base_col, 1e-5, flag)
    assert (int(pk), float(sk)) == (int(pp), float(sp))
    assert int(pk) not in set(basis.tolist()) or float(sk) >= ops.BASIC_PENALTY / 2
    if dtype == torch.float32:
        pj, sj = jxla.choose_entering_bounded(
            jnp.asarray(y), jnp.asarray(A[:, sl]), jnp.asarray(c[sl]), jnp.asarray(at_up[sl]),
            jnp.asarray(basis), jnp.int32(base_col), 1e-5, jnp.asarray(bland),
        )
        assert int(pk) == int(pj) + base_col  # the port returns the global column
        np.testing.assert_allclose(float(sk), float(sj), rtol=1e-6)


def test_signed_pricing_scan_checks_its_inputs():
    y, A, c = torch.zeros(3), torch.zeros(3, 5), torch.zeros(5)
    up, basis = torch.zeros(5, dtype=torch.bool), torch.arange(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="go together"):
        hopper.pricing_scan(y, A, c, 1e-6, up, None)
    with pytest.raises(ValueError, match="at_upper"):
        hopper.pricing_scan(y, A, c, 1e-6, up.int(), basis)
    with pytest.raises(ValueError, match="basis"):
        hopper.pricing_scan(y, A, c, 1e-6, up, basis[:2])
    with pytest.raises(ValueError, match="basis"):
        hopper.pricing_scan(y, A, c, 1e-6, up, basis.long())


# --------------------------------------------------------------------------
# one bounded pivot step from the same JAX state
# --------------------------------------------------------------------------


def bounded_problems(A, b, c, u):
    A, b, c, u = f32(A, b, c, u)
    jp = JaxProblem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c), u=jnp.asarray(u))
    return jp, problem_from_numpy(A, b, c, "cpu", u=u)


def leaves(s):
    d = {
        f: np.asarray(getattr(s, f))
        for f in ("B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen",
                  "last_refac", "at_upper")
    }
    if s.U.shape[0] > 1:
        d.update(U=np.asarray(s.U), R=np.asarray(s.R), npend=np.asarray(s.npend))
    d["pert"] = None if s.pert is None else tuple(np.asarray(v) for v in s.pert)
    return d


def close(t, j, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=what)


def assert_same(ts, js, inverse_only=False):
    np.testing.assert_array_equal(ts.basis.numpy(), np.asarray(js.basis))
    np.testing.assert_array_equal(ts.at_upper.numpy(), np.asarray(js.at_upper))
    for f in ("status", "iters", "degen"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    for f in ("x_b", "y", "c_b"):
        close(getattr(ts, f), getattr(js, f), f)
    if ts.U is None:
        close(ts.B_inv, js.B_inv, "B_inv")
        return
    close(ts.B_inv + ts.U.T @ ts.R, js.B_inv + js.U.T @ js.R, "B_inv + U.T R")
    if not inverse_only:
        assert int(ts.npend) == int(js.npend)
        for f in ("B_inv", "U", "R"):
            close(getattr(ts, f), getattr(js, f), f)


def walk(inst, jopts, k):
    A, b, c, u, at0 = inst
    jp, tp = bounded_problems(A, b, c, u)

    def fn(p, s):
        return JSTEP(p, s, jopts)

    js = jax_slack(
        jp, jnp.float32, update_defer=jopts.update_defer, perturb=True,
        at_upper0=None if at0 is None else jnp.asarray(at0),
    )
    for _ in range(k):
        js = fn(jp, js)
    return jp, tp, js, fn


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize(
    "inst,k,kind",
    [
        (ALL_FLIPS, 0, "flip"),
        (ALL_FLIPS, 1, "flip"),
        (LEAVE_UPPER, 0, "leave_upper"),
        (FROM_UPPER, 0, "flip"),
        (FROM_UPPER, 1, "flip"),
        (PIVOT_THEN_FLIP, 0, "pivot"),
        (PIVOT_THEN_FLIP, 1, "flip"),
    ],
)
def test_bounded_step_matches_jax(backend, inst, k, kind):
    jp, tp, js, fn = walk(inst, JaxOptions(), k)
    ts = state_from_numpy(leaves(js), "cpu")
    js1 = fn(jp, js)
    ts1 = step.pivot_step(tp, ts, SimplexOptions(backend=backend), dispatch.get_backend(backend))
    assert_same(ts1, js1)
    assert int(ts1.iters) == k + 1 and int(ts1.status) == SolveStatus.RUNNING
    moved = not np.array_equal(np.asarray(js1.basis), np.asarray(js.basis))
    assert moved == (kind != "flip")
    if kind == "leave_upper":
        assert bool(ts1.at_upper[1])  # s0 left at its upper bound 2


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("L", [4, 2])
def test_deferred_flip_step(backend, L):
    # step 0 pivots (one pair pending), step 1 flips. With L = 4 nothing
    # flushes and every leaf matches; with L = 2 the port flushes at the
    # host-known slot L - 1 on the flip step, where the JAX step keeps the
    # pair pending: the true inverse B_inv + U.T R is the same.
    jp, tp, js, fn = walk(PIVOT_THEN_FLIP, JaxOptions(update_defer=L), 1)
    assert int(js.npend) == 1
    ts = state_from_numpy(leaves(js), "cpu")
    js1 = fn(jp, js)
    opts = SimplexOptions(update_defer=L, backend=backend)
    ts1 = step.pivot_step(tp, ts, opts, dispatch.get_backend(backend))
    np.testing.assert_array_equal(np.asarray(js1.basis), np.asarray(js.basis))  # a flip
    assert_same(ts1, js1, inverse_only=(L == 2))
    if L == 2:
        assert int(ts1.npend) == 0 and int(js1.npend) == 1
        B = np.asarray(jp.A)[:, np.asarray(ts1.basis)].astype(np.float64)
        np.testing.assert_allclose(ts1.B_inv.double().numpy() @ B, np.eye(2), atol=1e-6)


def test_bounded_perturb_and_refactorize_match_jax():
    A, b, c, u = random_bounded(3, 12, 20)
    inst = (A, b, c, u, None)
    jp, tp, js, _ = walk(inst, JaxOptions(), 6)
    assert np.asarray(js.at_upper).any()  # some column sits at its bound
    ts = state_from_numpy(leaves(js), "cpu")
    scale = step.perturb_scale(SimplexOptions(), 1)
    jp2 = jstep.perturb_activate(jp, js, JB, scale)
    tp2 = step.perturb_activate(tp, ts, dispatch.get_backend("torch"), scale)
    close(tp2.x_b, jp2.x_b, "x_b", rtol=1e-6, atol=1e-7)
    close(tp2.pert.w, jp2.pert.w, "w", atol=1e-6)
    ub = np.asarray(jp.u)[np.asarray(js.basis)]
    assert np.all(tp2.x_b.numpy() >= -1e-7) and np.all(tp2.x_b.numpy() <= ub + 1e-6)
    jr = jstep.refactorize(jp, jstep.perturb_clear(jp2), JB)
    tr = step.refactorize(tp, step.perturb_clear(tp2), dispatch.get_backend("torch"))
    close(tr.x_b, jr.x_b, "x_b after refactorize")  # B x_b = b - A x_N
    close(tr.y, jr.y, "y after refactorize")


# --------------------------------------------------------------------------
# whole solves
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["all_flips", "leave_upper", "from_upper"])
def test_tie_free_solves_match_jax(name):
    A, b, c, u, at0 = {"all_flips": ALL_FLIPS, "leave_upper": LEAVE_UPPER,
                       "from_upper": FROM_UPPER}[name]
    A, b, c, u = f32(A, b, c, u)
    at0 = None if at0 is None else np.asarray(at0)
    res = solve(A, b, c, u=u, at_upper0=at0, device="cpu")
    ref = simplex_tpu.solve(A, b, c, u=u, at_upper0=at0)
    assert res.status == SolveStatus.OPTIMAL == int(ref.status)
    assert rel(res.z, highs(A, b, c, u)) <= GAP and rel(res.z, ref.z) <= GAP
    assert res.iters == ref.iters
    np.testing.assert_array_equal(res.basis, ref.basis)
    np.testing.assert_array_equal(res.at_upper, ref.at_upper)
    np.testing.assert_allclose(res.x, ref.x, atol=1e-6)
    assert res.feas_err <= 1e-6


FLAGSHIP_SMALL = dict(
    pricing_dtype="bfloat16", partial_pricing=4, partial_min_segment=2, update_defer=4,
    multi_price=8,
)


@pytest.mark.parametrize(
    "cfg,vs_jax",
    [
        (dict(), True),
        (FLAGSHIP_SMALL, True),
        (dict(ratio="classic"), False),
        (dict(bland_after=1), False),
        (dict(refactor_every=8), False),
        (dict(pricing_dtype="bfloat16"), False),
        (dict(update_defer=4), False),
        (dict(partial_pricing=4, partial_min_segment=2), False),
    ],
)
def test_bounded_solve_matches_jax_and_highs(cfg, vs_jax):
    # every option set against HiGHS; the default and the flagship set
    # (segments lowered to the test's size) against the JAX package too
    A, b, c, u = (v.astype(np.float32) for v in random_bounded(7, 16, 32))
    res = solve(A, b, c, u=u, options=SimplexOptions(**cfg), device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    assert rel(res.z, highs(A, b, c, u)) <= GAP
    if vs_jax:
        ref = simplex_tpu.solve(A, b, c, u=u, options=JaxOptions(**cfg))
        assert int(ref.status) == SolveStatus.OPTIMAL and rel(res.z, ref.z) <= GAP
    assert res.feas_err <= 1e-5
    assert np.all(res.x >= -1e-5) and np.all(res.x <= u + 1e-5)
    np.testing.assert_allclose(A.astype(np.float64) @ res.x, b, atol=1e-4)
    assert res.at_upper.dtype == bool and not res.at_upper[res.basis].any()


def test_start_at_upper_random():
    A, b, c, u = random_bounded(42, 16, 24, frac_bounded=0.5)
    at0 = np.isfinite(u)
    b = A @ np.where(at0, u, 0.0) + np.random.default_rng(1).uniform(0.5, 1.0, 16)
    A, b, c, u = f32(A, b, c, u)
    res = solve(A, b, c, u=u, at_upper0=at0, device="cpu")
    ref = simplex_tpu.solve(A, b, c, u=u, at_upper0=at0)
    assert res.status == SolveStatus.OPTIMAL == int(ref.status)
    assert rel(res.z, highs(A, b, c, u)) <= GAP and rel(res.z, ref.z) <= GAP


def test_unbounded_with_finite_bounds_elsewhere():
    A, b, c, u = f32([[1.0, -1.0, 1.0]], [1.0], [0.0, 1.0, 0.0], [2.0, np.inf, np.inf])
    res = solve(A, b, c, u=u, device="cpu")
    ref = simplex_tpu.solve(A, b, c, u=u)
    assert res.status == SolveStatus.UNBOUNDED == int(ref.status)


def test_all_inf_u_is_the_unbounded_path(monkeypatch):
    # the same backend calls, in number, as u=None; no bounded op runs
    A, b, c, _ = random_bounded(5, 12, 20)
    calls = []

    def counting(name):
        be = dispatch.get_backend(name)
        for op in vars(be):
            fn = getattr(be, op)
            if callable(fn):
                setattr(be, op, lambda *a, _f=fn, _op=op, **k: (calls.append(_op), _f(*a, **k))[1])
        return be

    monkeypatch.setattr(solver, "get_backend", counting)
    counts = []
    for u in (None, np.full(A.shape[1], np.inf)):
        calls.clear()
        res = solve(A, b, c, u=u, device="cpu")
        assert res.status == SolveStatus.OPTIMAL and res.at_upper is None
        counts.append({op: calls.count(op) for op in set(calls)})
    assert counts[0] == counts[1]
    # the unbounded step's ratio test runs inside its tail call
    assert "choose_entering_bounded" not in counts[0] and counts[0]["pivot_tail"] > 0


def test_bad_bounds_raise():
    A, b, c, u = random_bounded(0, 4, 6)
    with pytest.raises(ValueError, match="negative upper bound"):
        solve(A, b, c, u=np.where(np.isfinite(u), -1.0, u), device="cpu")
    with pytest.raises(ValueError, match="u shape"):
        solve(A, b, c, u=u[:-1], device="cpu")


def test_fixed_width_zero_upper():
    A, b, c, u = f32([[1.0, 1.0, 1.0]], [2.0], [5.0, 1.0, 0.0], [0.0, np.inf, np.inf])
    res = solve(A, b, c, u=u, device="cpu")
    assert res.status == SolveStatus.OPTIMAL and abs(res.z - 2.0) < 1e-6
    assert abs(res.x[0]) < 1e-7


def test_bounded_solve_needs_its_device():
    # without a card the default device raises; with one it solves there
    A, b, c, u = random_bounded(0, 4, 6)
    if torch.cuda.is_available():
        assert solve(A, b, c, u=u).status == SolveStatus.OPTIMAL
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            solve(A, b, c, u=u)
