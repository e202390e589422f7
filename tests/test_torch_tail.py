"""The port's one-call pricing and one-call pivot tail against the JAX
package's, on the CPU at small sizes.

``ops.pivot_tail`` (the plain version of the CUDA tail kernel; the hopper
wrapper given CPU tensors routes to it) takes a mid-solve JAX state (carried
over by ``state_from_numpy``), the entering column JAX's own backend picks
and a float32 ftran, and must return what ``simplex_tpu.core.step.pivot_step``
stores from that state: eager and deferred updates, Harris and classic,
Bland on and off, an optimal, an unbounded and a non-finite step. The masked
``choose_entering`` is held against ``simplex_tpu.kernels.xla``'s
``mask_basic`` + ``choose_entering`` and against the Pallas kernel in
interpret mode; ``pivot_tail``'s ratio test against ``pallas_ops.ratio_eta``
in interpret mode (``SIMPLEX_TPU_FUSED`` set in the test's environment
only). Inputs are numpy-seeded and float32 in both packages.

Tolerances: indices, flags, counts, status and basis exactly; x_b, y, c_b,
eta and the inverse's row to rtol 1e-6 / atol 1e-6 (the same elementwise
fp32 ops, but the two ftrans sum in another order and XLA may fuse a
multiply-add); reduced-cost minima to 1e-5 relative (fp32 sums in another
order); 1e-4 along the 60-pivot walks where errors accumulate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.core import step as jstep
from simplex_tpu.core.state import Problem as JaxProblem
from simplex_tpu.core.state import initial_state_slack as jax_slack
from simplex_tpu.kernels import pallas_ops as pk
from simplex_tpu.kernels import xla as xk
from simplex_tpu.kernels.dispatch import get_backend as jax_backend
from simplex_tpu.oracle.generator import klee_minty_lp, random_dense_lp
from simplex_tpu_torch import SimplexOptions, SolveStatus, load_lp
from simplex_tpu_torch.core import step
from simplex_tpu_torch.core.state import (
    initial_state_slack,
    problem_from_numpy,
    state_from_numpy,
)
from simplex_tpu_torch.kernels import _build, hopper, ops
from simplex_tpu_torch.kernels.dispatch import get_backend

JB = jax_backend("xla")
FLOATS = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture
def no_library(monkeypatch):
    """Fail any attempt to build or load the CUDA library."""

    def refuse(*_a, **_k):
        raise AssertionError("a CPU tensor reached the CUDA library")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(_build, "build", refuse)
    hopper.reset_launches()
    yield
    assert not any(hopper.launches.values()), hopper.launches


def rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def leaves(s, defer):
    d = {
        f: np.asarray(getattr(s, f))
        for f in ("B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen", "last_refac")
    }
    if defer:
        d.update({f: np.asarray(getattr(s, f)) for f in ("U", "R", "npend")})
    d["pert"] = None if s.pert is None else tuple(np.asarray(v) for v in s.pert)
    return d


def problems(A, b, c):
    A, b, c = (np.asarray(v, np.float32) for v in (A, b, c))
    return JaxProblem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c)), problem_from_numpy(A, b, c, "cpu")


def jax_walk(jp, jopts, k):
    fn = jax.jit(lambda p, s: jstep.pivot_step(p, s, jopts, JB))
    js = jax_slack(jp, jnp.float32, update_defer=jopts.resolve_defer(), perturb=True)
    for _ in range(k):
        js = fn(jp, js)
    return js, fn


def tail_from_jax_state(tail_fn, jp, js, opts, defer):
    """Run ``tail_fn`` on the JAX state ``js``: the entering column by the
    JAX backend's own pricing, the ftran in float32 numpy (plus the pending
    pairs), everything else carried over leaf by leaf. Returns the tail's
    result and the port's state it ran on."""
    ts = state_from_numpy(leaves(js, defer), "cpu")
    eps = opts.resolve_eps()
    use_bland = jnp.asarray(opts.bland_after > 0 and int(js.degen) >= opts.bland_after)
    p_j, min_j = JB.choose_entering(js.y, jp.A, JB.mask_basic(jp.c, js.basis), eps, use_bland)
    p = int(p_j)
    A = np.asarray(jp.A)
    A_p = A[:, p]
    y, B_inv = np.asarray(js.y), np.asarray(js.B_inv)
    alpha = B_inv @ A_p
    extra = {}
    if defer:
        U, R = np.asarray(js.U), np.asarray(js.R)
        alpha = alpha + U.T @ (R @ A_p)
        extra = dict(U=ts.U, R=ts.R, npend=int(js.npend), npend_t=ts.npend)
    c_p = np.float32(np.asarray(jp.c)[p])
    e_p = np.float32(y @ A_p) - c_p
    t = tail_fn(
        ts.x_b, torch.from_numpy(alpha.astype(np.float32)), ts.basis, ts.y, ts.c_b, ts.B_inv,
        torch.tensor(float(min_j)), torch.tensor(float(e_p)), torch.tensor(float(c_p)),
        torch.tensor(p, dtype=torch.int32), ts.iters, ts.degen,
        eps=eps, pivot_tol=opts.pivot_tol, feas_tol=opts.feas_tol,
        harris=opts.ratio == "harris", degen_tol=opts.degen_tol,
        bland_after=opts.bland_after, **extra,
    )
    return t, ts


def assert_tail_is_jax_step(t, js1):
    np.testing.assert_array_equal(t.basis.numpy(), np.asarray(js1.basis))
    for f in ("status", "iters", "degen"):
        assert int(getattr(t, f)) == int(getattr(js1, f)), f
    for f in ("x_b", "y", "c_b"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(js1, f)), err_msg=f, **FLOATS)


CASES = [
    # (ratio, bland_after, degen forced into the state, steps walked)
    ("harris", 64, None, 0),
    ("harris", 64, None, 6),
    ("classic", 64, None, 6),
    ("harris", 2, 5, 6),  # Bland's rule on: degen >= bland_after
    ("classic", 2, 5, 9),
]


@pytest.mark.parametrize("tail", ["ops", "hopper"])
@pytest.mark.parametrize("ratio,bland_after,degen,k", CASES)
def test_eager_tail_matches_jax_step(tail, ratio, bland_after, degen, k, no_library):
    jp, _ = problems(*random_dense_lp(24, 60, seed=3))
    jopts = JaxOptions(ratio=ratio, bland_after=bland_after)
    js, fn = jax_walk(jp, jopts, k)
    if degen is not None:
        js = js._replace(degen=jnp.asarray(degen, jnp.int32))
    js1 = fn(jp, js)
    opts = SimplexOptions(ratio=ratio, bland_after=bland_after)
    tail_fn = ops.pivot_tail if tail == "ops" else hopper.pivot_tail
    t, ts = tail_from_jax_state(tail_fn, jp, js, opts, defer=False)
    assert bool(t.take) and not bool(t.optimal) and not bool(t.unbounded) and not bool(t.bad)
    assert t.npend is None and int(t.iters) == k + 1
    assert_tail_is_jax_step(t, js1)
    # eta and the row are the rank-1 update JAX applied
    np.testing.assert_allclose(
        (ts.B_inv + torch.outer(t.eta, t.row)).numpy(), np.asarray(js1.B_inv), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_array_equal(t.row.numpy(), np.asarray(js.B_inv)[int(t.q)])


@pytest.mark.parametrize("tail", ["ops", "hopper"])
@pytest.mark.parametrize("ratio", ["harris", "classic"])
@pytest.mark.parametrize("k", [0, 2, 6])
def test_deferred_tail_matches_jax_step(tail, ratio, k, no_library):
    # L = 4: k = 2 and 6 find two pairs pending; the tail writes the third
    # into slot 2 of U and R in place and counts it
    L = 4
    jp, _ = problems(*random_dense_lp(24, 60, seed=3))
    js, fn = jax_walk(jp, JaxOptions(ratio=ratio, update_defer=L), k)
    assert int(js.npend) == k % L
    js1 = fn(jp, js)
    tail_fn = ops.pivot_tail if tail == "ops" else hopper.pivot_tail
    t, ts = tail_from_jax_state(tail_fn, jp, js, SimplexOptions(ratio=ratio, update_defer=L), defer=True)
    assert_tail_is_jax_step(t, js1)
    slot = k % L
    assert int(t.npend) == int(js1.npend) == slot + 1
    assert t.eta.data_ptr() == ts.U[slot].data_ptr() and t.row.data_ptr() == ts.R[slot].data_ptr()
    np.testing.assert_allclose(ts.U.numpy(), np.asarray(js1.U), err_msg="U", **FLOATS)
    np.testing.assert_allclose(ts.R.numpy(), np.asarray(js1.R), err_msg="R", **FLOATS)


def test_terminal_tails_change_nothing(no_library):
    # optimal: walk a small LP to its optimum, then one more step
    jp, _ = problems(*random_dense_lp(6, 15, seed=4))
    js, fn = jax_walk(jp, JaxOptions(), 0)
    for _ in range(200):
        js = fn(jp, js)
        if int(js.status) != SolveStatus.RUNNING:
            break
    assert int(js.status) == SolveStatus.OPTIMAL
    js = js._replace(status=jnp.asarray(int(SolveStatus.RUNNING), jnp.int32))
    js1 = fn(jp, js)
    t, ts = tail_from_jax_state(hopper.pivot_tail, jp, js, SimplexOptions(), defer=False)
    assert bool(t.optimal) and not bool(t.take) and int(t.status) == SolveStatus.OPTIMAL
    assert_tail_is_jax_step(t, js1)
    for f in ("x_b", "y", "c_b", "basis", "iters", "degen"):
        assert torch.equal(getattr(t, f), getattr(ts, f)), f
    assert float(t.eta.abs().max()) == 0.0 and float(t.row.abs().max()) == 0.0


def test_unbounded_and_non_finite_tails(no_library):
    jp, _ = problems(np.array([[-1.0, 1.0, 1.0]]), [1.0], [1.0, 0.0, 0.0])
    js, fn = jax_walk(jp, JaxOptions(), 0)
    js1 = fn(jp, js)
    t, ts = tail_from_jax_state(hopper.pivot_tail, jp, js, SimplexOptions(), defer=False)
    assert bool(t.unbounded) and not bool(t.take)
    assert int(t.status) == int(js1.status) == SolveStatus.UNBOUNDED
    assert_tail_is_jax_step(t, js1)
    assert float(t.eta.abs().max()) == 0.0 and torch.equal(t.x_b, ts.x_b)

    # a non-finite pricing value: SINGULAR in both packages, nothing moves
    jp, _ = problems(*random_dense_lp(8, 20, seed=5))
    js, fn = jax_walk(jp, JaxOptions(), 2)
    js = js._replace(y=js.y.at[0].set(jnp.nan))
    js1 = fn(jp, js)
    assert int(js1.status) == SolveStatus.SINGULAR
    ts = state_from_numpy(leaves(js, False), "cpu")
    alpha = torch.from_numpy(rand((8,), 1))
    for theta_inf in (False, True):
        # ... and a pivot about to be taken with a non-finite ratio
        x_b = torch.full_like(ts.x_b, float("inf")) if theta_inf else ts.x_b
        min_e = torch.tensor(-1.0 if theta_inf else float("nan"))
        t = hopper.pivot_tail(
            x_b, alpha.abs() + 1, ts.basis, ts.y, ts.c_b, ts.B_inv, min_e,
            torch.tensor(-1.0), torch.tensor(0.5), torch.tensor(3, dtype=torch.int32),
            ts.iters, ts.degen, eps=1e-5, pivot_tol=1e-7, feas_tol=1e-6, harris=True,
            degen_tol=1e-9, bland_after=64,
        )
        assert bool(t.bad) and not bool(t.take) and int(t.status) == SolveStatus.SINGULAR
        assert int(t.iters) == int(js1.iters) and int(t.degen) == int(js1.degen)
        np.testing.assert_array_equal(t.basis.numpy(), np.asarray(js1.basis))
        assert float(t.eta.abs().max()) == 0.0 and float(t.row.abs().max()) == 0.0


@pytest.mark.parametrize("m", [128, 256])
@pytest.mark.parametrize("harris", [True, False])
@pytest.mark.parametrize("bland", [False, True])
def test_tail_ratio_test_matches_pallas(m, harris, bland, monkeypatch, no_library):
    monkeypatch.setenv("SIMPLEX_TPU_FUSED", "1")
    rng = np.random.default_rng(m + harris + 2 * bland)
    x_b = rng.uniform(0, 1, m).astype(np.float32)
    x_b[::5] = 0.0
    alpha = rng.uniform(-1, 1, m).astype(np.float32)
    basis = rng.permutation(m).astype(np.int32)
    want = pk.ratio_eta(
        jnp.asarray(x_b), jnp.asarray(alpha), jnp.asarray(basis), 1e-7, jnp.asarray(bland), harris, 1e-6
    )
    assert want is not None
    B_inv = torch.from_numpy(rand((m, m), 3))
    t = hopper.pivot_tail(
        torch.from_numpy(x_b), torch.from_numpy(alpha), torch.from_numpy(basis),
        torch.from_numpy(rand((m,), 4)), torch.from_numpy(rand((m,), 5)), B_inv,
        torch.tensor(-1.0), torch.tensor(-1.0), torch.tensor(0.5),
        torch.tensor(7, dtype=torch.int32), torch.tensor(0, dtype=torch.int32),
        torch.tensor(3 if bland else 0, dtype=torch.int32),
        eps=1e-5, pivot_tol=1e-7, feas_tol=1e-6, harris=harris, degen_tol=1e-9, bland_after=3,
    )
    assert int(t.q) == int(want[0]) and bool(t.take) and not bool(want[2])
    np.testing.assert_allclose(float(t.theta_q), float(want[1]), rtol=1e-6)
    np.testing.assert_allclose(t.eta.numpy(), np.asarray(want[3]), rtol=1e-6)
    np.testing.assert_allclose(t.x_b.numpy(), np.asarray(want[4]), rtol=1e-6)
    assert torch.equal(t.row, B_inv[int(t.q)])
    assert int(t.basis[int(t.q)]) == 7 and float(t.c_b[int(t.q)]) == 0.5


# ---- the masked one-call pricing ----


def bf16_pair(shape, seed):
    a = torch.from_numpy(rand(shape, seed)).to(torch.bfloat16)
    return jnp.asarray(a.float().numpy()).astype(jnp.bfloat16), a


def pricing_case(m, n, bf16, seed):
    """y, c, a basis that holds the unmasked winners, and A in both
    packages (the same bf16-rounded values when ``bf16``)."""
    y, c = rand((m,), seed), rand((n,), seed + 1)
    if bf16:
        Aj, At = bf16_pair((m, n), seed + 2)
    else:
        A = rand((m, n), seed + 2)
        Aj, At = jnp.asarray(A), torch.from_numpy(A)
    e = y @ At.float().numpy() - c
    rng = np.random.default_rng(seed + 3)
    best = np.argsort(e)[: m // 2]
    rest = rng.permutation(np.setdiff1d(np.arange(n), best))[: m - len(best)]
    basis = rng.permutation(np.concatenate([best, rest])).astype(np.int32)
    return y, c, basis, Aj, At


@pytest.mark.parametrize("fn", ["ops", "hopper"])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("bland", [False, True])
@pytest.mark.parametrize("m,n,segments,s", [(16, 256, 1, 0), (16, 512, 4, 1), (32, 1024, 8, 5)])
def test_masked_choose_entering_matches_jax(fn, bf16, bland, m, n, segments, s, no_library):
    choose = ops.choose_entering if fn == "ops" else hopper.choose_entering
    y, c, basis, Aj, At = pricing_case(m, n, bf16, 30 + m)
    w = n // segments
    lo, hi = s * w, (s + 1) * w
    eps = 1e-5
    c_eff = xk.mask_basic(jnp.asarray(c), jnp.asarray(basis))
    # float32 y against the upcast shadow on both sides, as the Pallas
    # kernel and the port price it
    refs = [
        xk.choose_entering(jnp.asarray(y), Aj[:, lo:hi].astype(jnp.float32), c_eff[lo:hi], eps, jnp.asarray(bland)),
        pk.choose_entering(jnp.asarray(y), Aj[:, lo:hi], c_eff[lo:hi], eps, jnp.asarray(bland)),
    ]
    p_t, min_t = choose(
        torch.from_numpy(y), At[:, lo:hi], torch.from_numpy(c)[lo:hi], eps,
        torch.tensor(bland), torch.from_numpy(basis), lo,
    )
    assert p_t.dtype == torch.int32 and int(p_t) not in set(basis.tolist())
    for p_j, min_j in refs:
        assert int(p_t) == int(p_j) + lo  # the port's pick is a global column
        np.testing.assert_allclose(float(min_t), float(min_j), rtol=1e-5)
    assert float(min_t) < -eps


def test_masked_pricing_scan_penalizes_basic_columns(no_library):
    y, c, basis, _, At = pricing_case(16, 256, False, 40)
    yt, ct, bt = torch.from_numpy(y), torch.from_numpy(c), torch.from_numpy(basis)
    e = ops.reduced_costs(yt, At, ct)
    for fn in (hopper.pricing_scan_plain, hopper.pricing_scan):
        plain = fn(yt, At, ct, 1e-5)
        masked = fn(yt, At, ct, 1e-5, None, bt)
        assert int(plain[1]) in set(basis.tolist()) and int(masked[1]) not in set(basis.tolist())
        nonbasic = np.setdiff1d(np.arange(256), basis)
        # nonbasic values are unchanged to the bit; basic ones sit at 1e30
        assert float(masked[0]) == float(e[nonbasic].min())
    only_basic = hopper.pricing_scan(yt[:4], At[:4, :4], ct[:4], 1e-5, None, torch.arange(4, dtype=torch.int32))
    assert float(only_basic[0]) >= 0.5 * ops.BASIC_PENALTY and int(only_basic[2]) == ops.INT_MAX


# ---- the slice as a whole ----


def walk_both_backends(A, b, c, opts, steps):
    """The same pivot walk on the torch and the hopper backend (CPU tensors):
    every leaf equal, step for step. Returns the last state."""
    _, tp = problems(A, b, c)
    extras = dict(perturb=True, update_defer=opts.resolve_defer())
    states = {be: initial_state_slack(tp, torch.float32, **extras) for be in ("torch", "hopper")}
    for _ in range(steps):
        for be in states:
            states[be] = step.pivot_step(tp, states[be], opts, get_backend(be))
        a, h = states["torch"], states["hopper"]
        for f in ("B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen", "U", "R", "npend"):
            va, vh = getattr(a, f), getattr(h, f)
            assert (va is None and vh is None) or torch.equal(va, vh), f
        if int(a.status) != SolveStatus.RUNNING:
            break
    return states["hopper"]


@pytest.mark.parametrize("defer", [0, 4])
def test_backends_agree_leaf_for_leaf_on_klee_minty(defer, no_library):
    s = walk_both_backends(*klee_minty_lp(6), SimplexOptions(update_defer=defer), 60)
    assert int(s.iters) == 60 and int(s.status) == SolveStatus.RUNNING


@pytest.mark.parametrize("defer", [0, 4])
def test_backends_agree_leaf_for_leaf_on_sample(defer, no_library):
    A, b, c = load_lp("tests/data/sample.txt")
    s = walk_both_backends(A, b, c, SimplexOptions(update_defer=defer), 60)
    assert int(s.status) == SolveStatus.OPTIMAL
    assert abs(float(s.c_b @ s.x_b) - 9.0) < 1e-5


@pytest.mark.parametrize("opts", [dict(), dict(update_defer=4), dict(ratio="classic")])
def test_walk_matches_jax_step_for_step(opts, no_library):
    # tie-free: Dantzig walks Klee-Minty's vertices in one order
    jp, tp = problems(*klee_minty_lp(6))
    jopts, topts = JaxOptions(**opts), SimplexOptions(**opts)
    L = topts.resolve_defer()
    js = jax_slack(jp, jnp.float32, update_defer=L, perturb=True)
    ts = initial_state_slack(tp, torch.float32, perturb=True, update_defer=L)
    fn = jax.jit(lambda p, s: jstep.pivot_step(p, s, jopts, JB))
    be = get_backend("hopper")
    for _ in range(60):
        js, ts = fn(jp, js), step.pivot_step(tp, ts, topts, be)
        np.testing.assert_array_equal(ts.basis.numpy(), np.asarray(js.basis))
        for f in ("status", "iters", "degen"):
            assert int(getattr(ts, f)) == int(getattr(js, f)), f
        for f in ("x_b", "y", "c_b"):
            np.testing.assert_allclose(
                getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=1e-4, atol=1e-3, err_msg=f
            )
    assert int(ts.iters) == 60


# ---- input checks ----


def tail_args(m=4):
    f = torch.zeros(m)
    i32 = dict(dtype=torch.int32)
    return dict(
        x_b=f, alpha=torch.ones(m), basis=torch.arange(m, **i32), y=f, c_b=f, B_inv=torch.eye(m),
        min_e=torch.tensor(-1.0), e_p=torch.tensor(-1.0), c_p=torch.tensor(0.0),
        p=torch.tensor(0, **i32), iters=torch.tensor(0, **i32), degen=torch.tensor(0, **i32),
    )


KW = dict(eps=1e-5, pivot_tol=1e-7, feas_tol=1e-6, harris=True, degen_tol=1e-9, bland_after=64)


@pytest.mark.parametrize(
    "change",
    [
        dict(basis=torch.arange(4)),  # int64 basis
        dict(alpha=torch.ones(5)),  # shape
        dict(y=torch.zeros(4, dtype=torch.float64)),  # dtype
        dict(B_inv=torch.eye(5)),  # shape
        dict(B_inv=torch.zeros(4, 8)[:, ::2]),  # strided columns
        dict(min_e=torch.zeros(2)),  # not a scalar
        dict(p=torch.tensor(0)),  # int64 index
        dict(degen=torch.tensor(0.0)),  # float counter
    ],
)
def test_pivot_tail_rejects_unsupported_input(change, no_library):
    hopper.pivot_tail(*tail_args().values(), **KW)  # the unchanged arguments pass
    args = {**tail_args(), **change}
    with pytest.raises(ValueError):
        hopper.pivot_tail(*args.values(), **KW)


def test_pivot_tail_rejects_half_given_buffers(no_library):
    args = tail_args()
    U = torch.zeros(4, 4)
    with pytest.raises(ValueError, match="go together"):
        hopper.pivot_tail(*args.values(), **KW, U=U)
    with pytest.raises(ValueError, match="npend"):
        hopper.pivot_tail(
            *args.values(), **KW, U=U, R=U.clone(), npend=4, npend_t=torch.tensor(4, dtype=torch.int32)
        )
    with pytest.raises(ValueError, match="npend"):
        hopper.pivot_tail(*args.values(), **KW, npend=1)
    with pytest.raises(ValueError):
        hopper.pivot_tail(
            *args.values(), **KW, U=U, R=torch.zeros(3, 4), npend=0, npend_t=torch.tensor(0, dtype=torch.int32)
        )


def test_masked_pricing_rejects_unsupported_input(no_library):
    y, A, c = torch.zeros(3), torch.zeros(3, 8), torch.zeros(8)
    no, basis = torch.tensor(False), torch.arange(3, dtype=torch.int32)
    hopper.choose_entering(y, A, c, 1e-6, no, basis)
    with pytest.raises(ValueError):
        hopper.choose_entering(y, A, c, 1e-6, no, basis.long())  # dtype
    with pytest.raises(ValueError):
        hopper.choose_entering(y, A, c, 1e-6, no, basis[:2])  # shape
    with pytest.raises(ValueError):
        hopper.choose_entering(y, A, c, 1e-6, torch.tensor(0.0), basis)  # a float flag
    with pytest.raises(ValueError):
        hopper.choose_entering(y, A, c, 1e-6, torch.tensor([False, True]), basis)


def test_kernel_layout_helpers():
    # the cluster follows m: one block up to 1024 rows, 1088 takes two, 8
    # from 7169 on and beyond 8 x 1024 (a stride loop)
    assert [hopper._ratio_cluster(m) for m in (1, 1024, 1025, 1088, 4352, 7169, 8192, 9000, 10**6)] == [
        1, 1, 2, 2, 5, 8, 8, 8, 8
    ]
    # the row chunks are a function of the range's (m, n) alone
    assert hopper._pricing_chunks(8192, 16384) == (125, 66)
    assert hopper._pricing_chunks(8192, 2048) == (32, 256)
    rows, chunks = hopper._pricing_chunks(1088, 67648)
    assert rows * chunks >= 1088 > rows * (chunks - 1)
    # the scalar block's views: ints, theta's float bits, the flag bytes
    scal = torch.tensor([5, 0, 7, 1, 2, 3], dtype=torch.int32)
    scal[1] = torch.tensor(0.25).view(torch.int32)
    v = hopper._scalar_views(scal, torch.tensor([True, False, True, False]))
    assert (int(v["q"]), int(v["iters"]), int(v["status"]), int(v["degen"]), int(v["npend"])) == (5, 7, 1, 2, 3)
    assert float(v["theta_q"]) == 0.25 and v["theta_q"].dtype == torch.float32
    assert [bool(v[k]) for k in ("optimal", "unbounded", "bad", "take")] == [True, False, True, False]
    assert v["take"].dtype == torch.bool and v["q"].dim() == 0
