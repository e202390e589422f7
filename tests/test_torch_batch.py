"""The port's batched solves against the JAX package's.

``simplex_tpu_torch.batch`` (``solve_batched``, ``reoptimize_batched``, the
batched step and dual step) against ``simplex_tpu.batch.vmapped`` on the
xla backend and against the port's single ``solve``, on the CPU, at the
sizes of ``tests/test_batch.py`` and ``tests/test_dual.py``: statuses
equal and z within 1e-5 (1e-4 for the bf16 shadow and the warm re-solves,
as the JAX tests hold them); one batched step from a carried JAX state,
leaf by leaf; each batched plain twin against a loop of the single plain
op. Both backends run: the hopper wrappers take their plain twins on CPU
tensors.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from simplex_tpu import solve as jax_solve
from simplex_tpu.batch.vmapped import reoptimize_batched as jax_reoptimize_batched
from simplex_tpu.batch.vmapped import solve_batched as jax_solve_batched
from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.core import step as jstep
from simplex_tpu.core.state import Problem as JaxProblem
from simplex_tpu.core.state import initial_state_slack as jax_slack
from simplex_tpu.kernels.dispatch import get_backend as jax_backend
from simplex_tpu.oracle.generator import random_dense_lp
from simplex_tpu.oracle.reference import relative_gap, solve_scipy
from simplex_tpu_torch import SimplexOptions, SolveStatus, solve
from simplex_tpu_torch.batch import step as bstep
from simplex_tpu_torch.batch.vmapped import reoptimize_batched, solve_batched
from simplex_tpu_torch.core.state import Problem
from simplex_tpu_torch.kernels import dispatch, hopper, ops
from simplex_tpu_torch.sparse import from_dense

JB = jax_backend("xla")
BACKENDS = ["torch", "hopper"]


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the cores,
    and a torch parallel region (a sparse product enters one on every
    call) waits for threads that are not scheduled."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def stack_lps(B, m, n, seed0=100):
    lps = [random_dense_lp(m, n, seed=seed0 + s, dtype=np.float32) for s in range(B)]
    return [np.stack([lp[k] for lp in lps]) for k in range(3)]


def bounded_stack(B=4, m=6, k=14, seed=23):
    """``tests/test_batch.py::test_batched_native_bounds``'s instances."""
    rng = np.random.default_rng(seed)
    u = np.concatenate([rng.uniform(0.3, 1.0, k), np.full(m, np.inf)]).astype(np.float32)
    As, bs, cs = [], [], []
    for _ in range(B):
        A0 = rng.uniform(0.2, 1.5, (m, k))
        As.append(np.hstack([A0, np.eye(m)]).astype(np.float32))
        bs.append((A0 @ rng.uniform(0.2, 0.8, k) + rng.uniform(0.1, 1.0, m)).astype(np.float32))
        cs.append(np.concatenate([rng.uniform(0.5, 2, k), np.zeros(m)]).astype(np.float32))
    return np.stack(As), np.stack(bs), np.stack(cs), u


# (B, m, n, options, tolerance on z), each the size of its JAX test
CASES = {
    "default": (8, 12, 30, {}, 1e-5),
    "refactor": (4, 16, 40, {"refactor_every": 8}, 1e-5),
    "defer": (3, 8, 20, {"update_defer": 4}, 1e-5),
    "bf16": (4, 8, 20, {"pricing_dtype": "bfloat16"}, 1e-4),
    "classic": (4, 12, 30, {"ratio": "classic", "recompute_every": 5}, 1e-5),
}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", list(CASES))
def test_solve_batched_matches_jax_and_single(backend, case):
    B, m, n, opts, tol = CASES[case]
    As, bs, cs = stack_lps(B, m, n, seed0=100 if case != "defer" else 0)
    res = solve_batched(As, bs, cs, options=SimplexOptions(backend=backend, **opts), device="cpu")
    jres = jax_solve_batched(As, bs, cs, options=JaxOptions(**opts))
    assert res.z.shape == (B,) and res.x_b.shape == (B, m) and res.basis.shape == (B, m)
    assert res.feas_err is None
    np.testing.assert_array_equal(res.status, jres.status)
    for i in range(B):
        assert res.statuses()[i] == SolveStatus.OPTIMAL
        ref = solve_scipy(As[i], bs[i], cs[i])
        single = solve(As[i], bs[i], cs[i], options=SimplexOptions(backend=backend, **opts), device="cpu")
        assert relative_gap(float(res.z[i]), ref.z) < tol
        assert relative_gap(float(res.z[i]), float(jres.z[i])) < tol
        assert relative_gap(float(res.z[i]), single.z) < tol
    if case == "default":
        # divergent pivot counts must not corrupt each other
        assert len(set(res.iters.tolist())) > 1


@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_batched_mixed_statuses(backend):
    B, m, n = 4, 2, 5
    As, bs, cs = stack_lps(B, m, n)
    As[2] = np.array([[-1, -1, 0, 1, 0], [-2, -1, 0, 0, 1]], np.float32)
    cs[2] = np.array([1, 0, 0, 0, 0], np.float32)
    res = solve_batched(As, bs, cs, options=SimplexOptions(backend=backend), device="cpu")
    jres = jax_solve_batched(As, bs, cs)
    np.testing.assert_array_equal(res.status, jres.status)
    assert res.status[2] == SolveStatus.UNBOUNDED
    for i in (0, 1, 3):
        assert res.status[i] == SolveStatus.OPTIMAL
        assert relative_gap(float(res.z[i]), solve_scipy(As[i], bs[i], cs[i]).z) < 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("defer", [0, 4])
def test_solve_batched_shared_bounds(backend, defer):
    As, bs, cs, u = bounded_stack()
    opts = SimplexOptions(backend=backend, update_defer=defer)
    res = solve_batched(As, bs, cs, u=u, options=opts, device="cpu")
    jres = jax_solve_batched(As, bs, cs, u=u, options=JaxOptions(update_defer=defer))
    np.testing.assert_array_equal(res.status, jres.status)
    for i in range(As.shape[0]):
        single = solve(As[i], bs[i], cs[i], u=u, options=opts, device="cpu")
        assert SolveStatus(int(res.status[i])) == single.status == SolveStatus.OPTIMAL
        assert abs(float(res.z[i]) - single.z) < 1e-5 * (1 + abs(single.z))
        assert abs(float(res.z[i]) - float(jres.z[i])) < 1e-5 * (1 + abs(single.z))


def test_max_iter_leaves_instances_running_out():
    As, bs, cs = stack_lps(8, 12, 30)
    res = solve_batched(As, bs, cs, options=SimplexOptions(max_iter=4), device="cpu")
    jres = jax_solve_batched(As, bs, cs, options=JaxOptions(max_iter=4))
    np.testing.assert_array_equal(res.status, jres.status)
    np.testing.assert_array_equal(res.iters, jres.iters)
    assert (res.status == SolveStatus.MAX_ITER).any() and (res.iters <= 4).all()


def test_bf16_shadow_exact_pass_only_for_active_instances(monkeypatch):
    """The shadow's exact pass runs on a batch step only when an ACTIVE
    instance's winner fails its recheck: instances that finish at different
    steps leave the later steps to the shadow alone. The batch's exact
    passes fall on exactly the steps where some instance's solo solve takes
    one (no verify rounds, so each instance is at the same step in both)."""
    exact_at = []
    plain = ops.choose_entering_batched

    def counting(y, A, *args, **kw):
        if A.dtype == torch.float32:
            exact_at.append(bstep.steps["primal"])
        return plain(y, A, *args, **kw)

    monkeypatch.setattr(ops, "choose_entering_batched", counting)
    As, bs, cs = stack_lps(8, 12, 30)
    opts = SimplexOptions(pricing_dtype="bfloat16", verify_terminal=False)
    bstep.reset_host_reads()
    res = solve_batched(As, bs, cs, options=opts, device="cpu")
    batch_steps = set(exact_at)
    assert len(set(res.iters.tolist())) > 1  # instances finish at different steps
    solo = set()
    for i in range(8):
        exact_at.clear()
        bstep.reset_host_reads()
        one = solve_batched(As[i : i + 1], bs[i : i + 1], cs[i : i + 1], options=opts, device="cpu")
        assert int(one.iters[0]) == int(res.iters[i])
        solo |= set(exact_at)
    assert batch_steps == solo


# --------------------------------------------------------------------------
# one batched step from a carried JAX state
# --------------------------------------------------------------------------


def jax_batch_walk(As, bs, cs, jopts, k, u=None):
    """The vmapped JAX state after k vmapped pivot steps from the slack
    basis (a finished instance is a fixed point of the step)."""
    ju = None if u is None else jnp.asarray(u)

    def prob(A, b, c):
        return JaxProblem(A, b, c, u=ju)

    def init(A, b, c):
        return jax_slack(prob(A, b, c), jnp.float32, jopts.pricing, jopts.update_defer)

    step = jax.jit(jax.vmap(lambda A, b, c, s: jstep.pivot_step(prob(A, b, c), s, jopts, JB)))
    args = tuple(jnp.asarray(v) for v in (As, bs, cs))
    js = jax.vmap(init)(*args)
    for _ in range(k):
        js = step(*args, js)
    return js, step, args


def carried(js, defer, bounded):
    names = ["B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen", "last_refac"]
    if defer:
        names += ["U", "R", "npend"]
    d = {f: np.asarray(getattr(js, f)) for f in names}
    if bounded:
        d["at_upper"] = np.asarray(js.at_upper)
    return d


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("kind", ["eager", "defer", "bounded", "bf16"])
@pytest.mark.parametrize("k", [0, 2])
def test_batched_step_matches_jax(backend, kind, k):
    u = None
    if kind == "bounded":
        As, bs, cs, u = bounded_stack()
    else:
        As, bs, cs = stack_lps(5, 12, 30)
    defer = 4 if kind == "defer" else 0
    jopts = JaxOptions(update_defer=defer, pricing_dtype="bfloat16" if kind == "bf16" else "float32")
    opts = SimplexOptions(backend=backend, update_defer=defer, pricing_dtype=jopts.pricing_dtype)
    js, jstep_fn, jargs = jax_batch_walk(As, bs, cs, jopts, k, u)
    s = bstep.batch_state_from_numpy(carried(js, defer, u is not None), "cpu")
    prob = Problem(
        A=torch.as_tensor(As), b=torch.as_tensor(bs), c=torch.as_tensor(cs),
        u=None if u is None else torch.as_tensor(u),
    )
    if kind == "bf16":
        prob.A_price = prob.A.to(torch.bfloat16)
    ctl = bstep.batch_control(s, opts, 10_000)
    s1 = bstep.batch_pivot_step(prob, s, opts, dispatch.get_backend(backend), ctl)
    js1 = jstep_fn(*jargs, js)
    np.testing.assert_array_equal(s1.basis.numpy(), np.asarray(js1.basis))
    for f in ("status", "iters", "degen"):
        np.testing.assert_array_equal(getattr(s1, f).numpy(), np.asarray(getattr(js1, f)), err_msg=f)
    floats = ["B_inv", "x_b", "y", "c_b"] + (["U", "R"] if defer else [])
    for f in floats:
        np.testing.assert_allclose(getattr(s1, f).numpy(), np.asarray(getattr(js1, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    if defer:
        np.testing.assert_array_equal(s1.npend.numpy(), np.asarray(js1.npend))
    if u is not None:
        np.testing.assert_array_equal(s1.at_upper.numpy(), np.asarray(js1.at_upper))


def test_finished_instances_are_left_bit_for_bit():
    As, bs, cs = stack_lps(6, 12, 30)
    opts = SimplexOptions(backend="torch")
    prob = Problem(A=torch.as_tensor(As), b=torch.as_tensor(bs), c=torch.as_tensor(cs))
    s = bstep.batch_state_slack(prob, torch.float32)
    s.status[[1, 4]] = int(SolveStatus.OPTIMAL)
    before = {f: getattr(s, f).clone() for f in ("B_inv", "x_b", "y", "c_b", "basis", "iters", "degen")}
    s1 = bstep.batch_pivot_step(prob, s, opts, dispatch.get_backend("torch"), bstep.batch_control(s, opts, 100))
    for f, t in before.items():
        for i in (1, 4):
            assert torch.equal(getattr(s1, f)[i], t[i]), f
        assert not torch.equal(getattr(s1, f)[0], t[0]) or f in ("degen",), f
    assert (s1.status[[1, 4]] == int(SolveStatus.OPTIMAL)).all()


# --------------------------------------------------------------------------
# warm re-solves
# --------------------------------------------------------------------------

OPTS_WARM = dict(refactor_every=64)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("storage", ["dense", "scipy"])
def test_reoptimize_batched_serving(backend, storage):
    A, b, c = random_dense_lp(12, 30, seed=31)
    cold = solve(A, b, c, options=SimplexOptions(**OPTS_WARM), device="cpu")
    jcold = jax_solve(A, b, c, options=JaxOptions(**OPTS_WARM))
    rng = np.random.default_rng(9)
    bs2 = np.stack(
        [np.asarray(b, np.float64) * (1 + 0.2 * rng.uniform(-1, 1, b.shape)) for _ in range(8)]
    ).astype(np.float32)
    A_in = A if storage == "dense" else sps.csc_matrix(A)
    res = reoptimize_batched(A_in, bs2, c, cold, options=SimplexOptions(backend=backend, **OPTS_WARM), device="cpu")
    jres = jax_reoptimize_batched(A, bs2, c, jcold, options=JaxOptions(**OPTS_WARM))
    np.testing.assert_array_equal(res.status, jres.status)
    assert res.feas_err is not None and res.feas_err.shape == (8,)
    for i in range(8):
        ref = solve_scipy(A, bs2[i], c)
        assert SolveStatus(int(res.status[i])) == ref.status, i
        if ref.status == SolveStatus.OPTIMAL:
            assert relative_gap(float(res.z[i]), ref.z) < 1e-4, i
            assert relative_gap(float(res.z[i]), float(jres.z[i])) < 1e-4, i
            assert float(res.feas_err[i]) < 1e-4


def test_reoptimize_batched_sparse_matches_dense():
    """``tests/test_sparse_general.py::test_reoptimize_batched_sparse``'s
    instance: one shared sparse A (scipy, and the port's SparseA) serves
    every scenario; answers match the dense batched path and JAX's."""
    from simplex_tpu_torch.sparse import from_scipy
    from tests.test_sparse import _sparse_canonical

    A, b, c = _sparse_canonical(12, 30, density=0.3, seed=71)
    prev = solve(A, b, c, device="cpu")
    rng = np.random.default_rng(72)
    bs_new = np.stack([b * rng.uniform(0.9, 1.1, size=b.shape) for _ in range(6)]).astype(np.float32)
    dense = reoptimize_batched(A, bs_new, c, prev, device="cpu")
    jres = jax_reoptimize_batched(A, bs_new, c, jax_solve(A, b, c))
    for A_sp in (sps.csr_matrix(A), from_scipy(sps.csr_matrix(A), device="cpu")):
        spr = reoptimize_batched(A_sp, bs_new, c, prev, device="cpu")
        np.testing.assert_array_equal(spr.status, dense.status)
        np.testing.assert_array_equal(spr.status, jres.status)
        for i in range(6):
            if SolveStatus(int(dense.status[i])) == SolveStatus.OPTIMAL:
                assert relative_gap(float(spr.z[i]), float(dense.z[i])) < 1e-4
                assert relative_gap(float(spr.z[i]), float(jres.z[i])) < 1e-4
        assert float(spr.feas_err.max()) < 1e-4


@pytest.mark.parametrize("backend", BACKENDS)
def test_reoptimize_batched_mixed_statuses(backend):
    A = np.array([[1.0, 1.0, 1.0]], np.float32)
    b = np.array([5.0], np.float32)
    c = np.array([-1.0, -2.0, 0.0], np.float32)
    cold = solve(A, b, c, options=SimplexOptions(**OPTS_WARM), device="cpu")
    bs2 = np.array([[3.0], [-1.0]], np.float32)
    res = reoptimize_batched(A, bs2, c, cold, options=SimplexOptions(backend=backend, **OPTS_WARM), device="cpu")
    jres = jax_reoptimize_batched(A, bs2, c, jax_solve(A, b, c, options=JaxOptions(**OPTS_WARM)),
                                  options=JaxOptions(**OPTS_WARM))
    np.testing.assert_array_equal(res.status, jres.status)
    assert SolveStatus(int(res.status[0])) == SolveStatus.OPTIMAL
    assert SolveStatus(int(res.status[1])) == SolveStatus.INFEASIBLE
    assert abs(float(res.z[0])) < 1e-5


def test_reoptimize_batched_bounded_long_step():
    """Shared bounds: the long step with its stable argsort, against the
    JAX package's vmapped warm loop."""
    As, bs, cs, u = bounded_stack(B=1, m=6, k=14, seed=5)
    A, b, c = As[0], bs[0], cs[0]
    cold = solve(A, b, c, u=u, device="cpu")
    jcold = jax_solve(A, b, c, u=u)
    rng = np.random.default_rng(3)
    bs2 = (b[None, :] * (1 + 0.3 * rng.uniform(-1, 1, (6, b.shape[0])))).astype(np.float32)
    res = reoptimize_batched(A, bs2, c, cold, u=u, device="cpu")
    jres = jax_reoptimize_batched(A, bs2, c, jcold, u=u)
    np.testing.assert_array_equal(res.status, jres.status)
    for i in range(6):
        single = solve(A, bs2[i], c, u=u, device="cpu")
        assert SolveStatus(int(res.status[i])) == single.status
        if single.status == SolveStatus.OPTIMAL:
            assert abs(float(res.z[i]) - single.z) < 1e-4 * (1 + abs(single.z))
            assert abs(float(res.z[i]) - float(jres.z[i])) < 1e-4 * (1 + abs(single.z))


def test_reoptimize_batched_refuses_a_dual_infeasible_basis():
    A, b, c = random_dense_lp(12, 30, seed=31)
    with pytest.raises(ValueError, match="not dual-feasible"):
        reoptimize_batched(A, b[None], c, np.arange(18, 30), device="cpu")


# --------------------------------------------------------------------------
# the batched plain twins against loops of the single plain ops
# --------------------------------------------------------------------------


def _g(seed=0):
    return torch.Generator().manual_seed(seed)


@pytest.mark.parametrize("layout", ["stack", "shared", "shared tile tails"])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
def test_choose_entering_batched_is_a_loop_of_the_single_op(signed, dtype, layout):
    """Per instance A and c: bit for bit the single op's. One A and c that
    every instance shares (the warm re-solve's clean-up): one matrix
    product sums in another order than the single op's, so e agrees to
    rounding and every pick is the same; also at 65 x 33 x 129, one past
    the fp32 kernel's tile on every axis (64 instances, 32 rows a stage,
    128 columns; in float64 past 32 rows and 64 columns, and 129 x 33 x 129
    past 128 instances). float64: A, y and c in double."""
    g = _g(1)
    B, m, n = (65, 33, 129) if layout == "shared tile tails" else (6, 17, 45)
    vt = torch.float64 if dtype == torch.float64 else torch.float32
    if layout == "shared tile tails" and vt == torch.float64:
        B = 129
    shared = layout != "stack"
    y = torch.randn(B, m, generator=g, dtype=vt)
    c = torch.randn(n, generator=g, dtype=vt) if shared else torch.randn(B, n, generator=g, dtype=vt)
    A = torch.randn(*(() if shared else (B,)), m, n, generator=g, dtype=vt).to(dtype)
    basis = torch.stack([torch.randperm(n, generator=g)[:m] for _ in range(B)]).to(torch.int32)
    bland = torch.arange(B) % 6 % 2 == 1
    up = torch.rand(B, n, generator=g) < 0.3 if signed else None
    for fn in (ops.choose_entering_batched, hopper.choose_entering_batched):
        p, min_e = fn(y, A, c, 1e-5, bland, basis, up)
        for i in range(B):
            A_i, c_i = (A, c) if shared else (A[i], c[i])
            if signed:
                p1, m1 = ops.choose_entering_bounded(y[i], A_i, c_i, up[i], basis[i], 0, 1e-5, bland[i])
            else:
                p1, m1 = ops.choose_entering(y[i], A_i, c_i, 1e-5, bland[i], basis[i])
            assert int(p[i]) == int(p1), i
            if shared:
                assert torch.allclose(min_e[i], m1, rtol=1e-6, atol=1e-5), i
            else:
                assert torch.equal(min_e[i], m1), i


def tail_case(B=7, m=17, L=0, seed=2):
    g = _g(seed)
    x_b = torch.rand(B, m, generator=g)
    x_b[:, ::5] = 0
    alpha = torch.randn(B, m, generator=g)
    alpha[2] = -alpha[2].abs()
    t = dict(
        x_b=x_b, alpha=alpha,
        basis=torch.stack([torch.randperm(60, generator=g)[:m] for _ in range(B)]).to(torch.int32),
        y=torch.randn(B, m, generator=g), c_b=torch.randn(B, m, generator=g),
        B_inv=torch.randn(B, m, m, generator=g),
        min_e=-torch.rand(B, generator=g), c_p=torch.randn(B, generator=g),
        p=torch.randint(0, 60, (B,), generator=g).to(torch.int32),
        iters=torch.randint(0, 9, (B,), generator=g).to(torch.int32),
        degen=torch.tensor([0, 70, 3, 0, 65, 1, 2][:B], dtype=torch.int32),
    )
    t["e_p"] = t["min_e"].clone()
    t["min_e"][3] = 0.25  # optimal
    t["status"] = torch.zeros(B, dtype=torch.int32)
    t["status"][5] = int(SolveStatus.OPTIMAL)
    t["active"] = t["status"] == 0
    if L:
        t["npend"] = torch.tensor([0, 1, 3, 2, 0, 1, 3][:B], dtype=torch.int32)
        live = (torch.arange(L)[None, :, None] < t["npend"][:, None, None]).float()
        t["U"] = torch.randn(B, L, m, generator=g) * live
        t["R"] = torch.randn(B, L, m, generator=g) * live
    return t


TAIL_ARGS = ("x_b", "alpha", "basis", "y", "c_b", "B_inv", "min_e", "e_p", "c_p", "p", "iters", "degen")
TAIL_OPTS = dict(eps=1e-5, pivot_tol=1e-7, feas_tol=1e-6, degen_tol=1e-9, bland_after=64)


@pytest.mark.parametrize("harris", [True, False])
@pytest.mark.parametrize("L", [0, 4])
def test_pivot_tail_batched_is_a_loop_of_the_single_op(harris, L):
    t = tail_case(L=L)
    extra = dict(U=t["U"].clone(), R=t["R"].clone(), npend=t["npend"]) if L else {}
    got = ops.pivot_tail_batched(*(t[k] for k in TAIL_ARGS), t["status"], t["active"],
                                 harris=harris, **TAIL_OPTS, **extra)
    via_wrapper = hopper.pivot_tail_batched(
        *(t[k] for k in TAIL_ARGS), t["status"], t["active"], harris=harris, **TAIL_OPTS,
        **(dict(U=t["U"].clone(), R=t["R"].clone(), npend=t["npend"]) if L else {}),
    )
    for f in got._fields:
        a, b = getattr(got, f), getattr(via_wrapper, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    for i in range(t["x_b"].shape[0]):
        if not bool(t["active"][i]):
            # left as it was, bit for bit
            for f in ("x_b", "y", "c_b", "basis", "iters", "degen", "status"):
                assert torch.equal(getattr(got, f)[i], t[f][i]), f
            assert not bool(got.take[i]) and not got.eta[i].any() and not got.row[i].any()
            continue
        kw = {}
        if L:
            U, R = t["U"][i].clone(), t["R"][i].clone()
            kw = dict(U=U, R=R, npend=int(t["npend"][i]), npend_t=t["npend"][i])
        one = ops.pivot_tail(*(t[k][i] for k in TAIL_ARGS), harris=harris, **TAIL_OPTS, **kw)
        for f in ("x_b", "c_b", "basis", "iters", "status", "degen", "eta", "q", "theta_q", "take",
                  "optimal", "unbounded", "bad"):
            assert torch.equal(getattr(got, f)[i], getattr(one, f).to(getattr(got, f).dtype)), (f, i)
        for f in ("y", "row"):
            # the pending pairs: in pair order here, a matrix product there
            close = torch.allclose if L else torch.equal
            args = dict(rtol=1e-6, atol=1e-6) if L else {}
            assert close(getattr(got, f)[i], getattr(one, f), **args), (f, i)
        if L:
            assert torch.allclose(extra["U"][i], U) and torch.allclose(extra["R"][i], R, atol=1e-6)
            assert int(got.npend[i]) == int(one.npend)


def test_rank1_update_batched_is_a_loop_of_the_single_op():
    g = _g(3)
    B, m = 5, 17
    B_inv = torch.randn(B, m, m, generator=g)
    eta, row = torch.randn(B, m, generator=g), torch.randn(B, m, generator=g)
    take = torch.tensor([True, False, True, True, False])
    got = ops.rank1_update_batched(B_inv.clone(), eta, row, take)
    assert torch.equal(hopper.rank1_update_batched(B_inv.clone(), eta, row, take), got)
    for i in range(B):
        if not take[i]:
            assert torch.equal(got[i], B_inv[i])
            continue
        # bit for bit the unfused multiply and add the kernel computes; the
        # single op (a BLAS ger) may fuse them, so it agrees to rounding
        assert torch.equal(got[i], B_inv[i] + eta[i][:, None] * row[i][None, :])
        one = ops.rank1_update(B_inv[i].clone(), eta[i], row[i])
        assert torch.allclose(got[i], one, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("harris", [True, False])
def test_ratio_argmin_bounded_batched_is_a_loop_of_the_single_op(harris):
    g = _g(4)
    B, m = 6, 13
    x_b = torch.rand(B, m, generator=g)
    d = torch.randn(B, m, generator=g)
    u_basic = torch.where(torch.rand(B, m, generator=g) < 0.5, torch.rand(B, m, generator=g) + 1, float("inf"))
    u_p = torch.tensor([0.1, float("inf"), 2.0, 0.01, float("inf"), 0.5])
    basis = torch.stack([torch.randperm(40, generator=g)[:m] for _ in range(B)]).to(torch.int32)
    bland = torch.tensor([False, True, False, False, True, False])
    out = ops.ratio_argmin_bounded_batched(x_b, d, u_basic, u_p, basis, 1e-7, bland, harris, 1e-6)
    for i in range(B):
        one = ops.ratio_argmin_bounded(x_b[i], d[i], u_basic[i], u_p[i], basis[i], 1e-7, bland[i], harris, 1e-6)
        for a, b in zip(out, one):
            assert torch.equal(a[i], b.to(a.dtype)), i


@pytest.mark.parametrize(
    "shape, shared, bf16, align, want",
    [
        # bench.py --mode batch's shape: one launch, the choice in the block
        ((4096, 64, 160), False, False, 16, dict(layout="scan", grid=(1, 4096), threads=256,
                                                 chunks=1, words=0, scratch_words=0, launches=1)),
        ((4096, 64, 160), False, True, 16, dict(layout="bf16x4", grid=(1, 4096), threads=64,
                                                chunks=1, scratch_words=0, launches=1)),
        # the bf16 path's 8-byte loads need n % 4 == 0 and an aligned A
        ((4096, 64, 160), False, True, 4, dict(layout="scan", threads=256)),
        ((3, 17, 45), False, True, 16, dict(layout="scan")),
        ((5, 33, 258), False, True, 16, dict(layout="scan", grid=(2, 5), chunks=2,
                                             scratch_words=5 * 2 * 3, launches=2)),
        ((7, 9, 516), False, True, 16, dict(layout="bf16x4", grid=(3, 7), chunks=3,
                                            scratch_words=7 * 3 * 3, launches=2)),
        # bench.py --mode reopt's shared A: mask, the tiled product, reduction
        ((256, 2048, 4096), True, False, 16, dict(layout="shared", grid=(32, 4), threads=256,
                                                  chunks=32, words=128, launches=3,
                                                  scratch_words=256 * 128 + 256 * 32 * 3)),
        ((256, 2048, 4096), True, True, 16, dict(layout="shared", grid=(32, 4))),
        # 16-byte copies need m % 4 == 0, rows of a multiple of 16 bytes and
        # 16-byte alignment; else the product's element loads
        ((256, 2048, 4096), True, False, 8, dict(layout="shared_loads", grid=(32, 4))),
        ((130, 257, 1000), True, False, 16, dict(layout="shared_loads", grid=(8, 3))),
        ((130, 260, 1000), True, True, 16, dict(layout="shared", grid=(8, 3), chunks=8, words=32)),
        ((130, 260, 1004), True, True, 16, dict(layout="shared_loads")),
        ((130, 260, 1004), True, False, 16, dict(layout="shared")),
        # one tile: the product writes the choice, no reduction launch
        ((1, 1, 1), True, False, 16, dict(layout="shared_loads", grid=(1, 1), chunks=1, words=1,
                                          scratch_words=1, launches=2)),
        ((65, 32, 128), True, False, 16, dict(layout="shared", grid=(1, 2), chunks=1, words=4,
                                              scratch_words=65 * 4, launches=2)),
    ],
)
def test_batch_pricing_plan(shape, shared, bf16, align, want):
    plan = hopper.batch_pricing_plan(*shape, shared=shared, bf16=bf16, align=align)
    assert {k: plan[k] for k in want} == want


def test_batch_pricing_plan_grid_limit():
    """Per instance the instances ride on grid.y (at most 65,535); a shared A
    puts its tiles of 64 instances there."""
    plan = hopper.batch_pricing_plan
    assert plan(65535, 4, 9, shared=False, bf16=False, align=16)["grid"] == (1, 65535)
    with pytest.raises(ValueError, match="grid"):
        plan(65536, 4, 9, shared=False, bf16=False, align=16)
    assert plan(65536, 4, 9, shared=True, bf16=False, align=16)["grid"] == (1, 1024)
    assert plan(65535 * 64, 4, 9, shared=True, bf16=False, align=16)["grid"] == (1, 65535)
    with pytest.raises(ValueError, match="grid"):
        plan(65535 * 64 + 1, 4, 9, shared=True, bf16=False, align=16)


@pytest.mark.parametrize(
    "m, align, want",
    [
        (1, 16, ("warp", 1, 1)), (17, 16, ("warp", 1, 1)), (32, 16, ("warp", 1, 1)),
        (33, 16, ("warp", 2, 1)), (64, 16, ("warp", 2, 2)), (64, 4, ("warp", 2, 1)),
        (100, 16, ("warp", 4, 4)), (100, 8, ("warp", 4, 1)), (128, 16, ("warp", 4, 4)),
        (129, 16, ("warp", 8, 1)), (256, 16, ("warp", 8, 4)), (257, 16, ("block", 0, 1)),
        (1100, 16, ("block", 0, 1)), (2048, 16, ("block", 0, 1)),
    ],
)
def test_batch_tail_plan(m, align, want):
    """One warp an instance (four a block) up to 256 rows, 1-8 rows a lane,
    loads of 4 (or 2) rows where m and the alignment allow; one block an
    instance beyond, a thread a row up to 512."""
    plan = hopper.batch_tail_plan(37, m, align)
    assert (plan["path"], plan["rows_per_lane"], plan["vec"]) == want
    if plan["path"] == "warp":
        assert 32 * plan["rows_per_lane"] >= m and (plan["threads"], plan["blocks"]) == (128, 10)
    else:
        assert plan["blocks"] == 37 and plan["threads"] == min(512, -(-m // 32) * 32)
    assert hopper._TAIL_WARP_MAX_M == 32 * 8


def test_batched_wrappers_check_their_inputs():
    B, m, n = 3, 4, 9
    y, A, c = torch.zeros(B, m), torch.zeros(B, m, n), torch.zeros(B, n)
    basis = torch.zeros(B, m, dtype=torch.int32)
    bland = torch.zeros(B, dtype=torch.bool)
    with pytest.raises(ValueError, match="basis"):
        hopper.choose_entering_batched(y, A, c, 1e-5, bland, basis.long())
    with pytest.raises(ValueError, match="A"):
        hopper.choose_entering_batched(y, A.double(), c, 1e-5, bland, basis)
    with pytest.raises(ValueError, match="A"):
        # no kernel reads a sparse A: the batched step prices it itself
        hopper.choose_entering_batched(y, from_dense(A[0], device="cpu"), c, 1e-5, bland, basis)
    with pytest.raises(ValueError, match="c"):
        hopper.choose_entering_batched(y, A[0], c[:, :-1], 1e-5, bland, basis)
    B_inv = torch.zeros(B, m, m)
    with pytest.raises(ValueError, match="overlap|contiguous"):
        hopper.rank1_update_batched(B_inv, torch.zeros(B, m), B_inv[:, 0], bland)
    with pytest.raises(ValueError, match="take"):
        hopper.rank1_update_batched(B_inv, torch.zeros(B, m), torch.zeros(B, m), bland.int())
    t = tail_case(m=m)
    with pytest.raises(ValueError, match="U, R and npend"):
        hopper.pivot_tail_batched(*(t[k] for k in TAIL_ARGS), t["status"], t["active"], harris=True,
                                  **TAIL_OPTS, U=torch.zeros(7, 2, m))
    # the kernels' vector loads follow the alignment of every pointer the
    # call passes: an offset view takes the element-load path
    buf = torch.zeros(2 * B * n + 4)
    assert hopper._alignment(buf[:B * n].view(B, n), buf[4:4 + B * n]) == 16
    assert hopper._alignment(buf[2:2 + B * n].view(B, n)) == 8
    assert hopper._alignment(buf[:B * n], buf[1:1 + B * n]) == 4
    assert hopper._alignment(buf.to(torch.bfloat16)[1:]) == 2


# --------------------------------------------------------------------------
# what the batched paths refuse
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "opts, what",
    [
        (dict(pricing="devex"), "16b"),
        (dict(pricing="steepest"), "16b"),
        (dict(partial_pricing=4), "16b"),
    ],
)
def test_unported_batch_options_raise(opts, what):
    """The options ROADMAP item 16b ported to the batched paths (devex,
    steepest edge, segmented pricing) no longer raise: both entry points
    run them and agree with the JAX package's statuses and answers
    (``tests/test_torch_batch_rules.py`` holds them at full depth)."""
    As, bs, cs = stack_lps(2, 4, 10)
    res = solve_batched(As, bs, cs, options=SimplexOptions(**opts), device="cpu")
    jres = jax_solve_batched(As, bs, cs, options=JaxOptions(**opts))
    np.testing.assert_array_equal(res.status, jres.status)
    np.testing.assert_allclose(res.z, jres.z, rtol=1e-5)
    A, b, c = random_dense_lp(4, 10, seed=1)
    cold = solve(A, b, c, device="cpu")
    warm = reoptimize_batched(A, b[None], c, cold, options=SimplexOptions(**opts), device="cpu")
    assert SolveStatus(int(warm.status[0])) == SolveStatus.OPTIMAL, what
    assert relative_gap(float(warm.z[0]), cold.z) < 1e-5


def test_mesh_raises_and_multi_price_warns():
    # a mesh runs the batch over its ranks (tests/test_torch_dist_batch.py);
    # anything else given as mesh= is refused
    As, bs, cs = stack_lps(3, 8, 20)
    with pytest.raises(TypeError, match="DeviceMesh"):
        solve_batched(As, bs, cs, mesh=object(), device="cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        reoptimize_batched(As[0], bs, cs[0], np.arange(12, 20), mesh=object(), device="cpu")
    import logging

    from simplex_tpu_torch.logging import get_logger

    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    log = get_logger("batch")
    log.addHandler(handler)
    try:
        res = solve_batched(As, bs, cs, options=SimplexOptions(multi_price=8), device="cpu")
    finally:
        log.removeHandler(handler)
    assert any("multi_price=8 is inert in solve_batched" in msg for msg in seen)
    plain = solve_batched(As, bs, cs, device="cpu")
    np.testing.assert_array_equal(res.basis, plain.basis)


def test_batch_entry_points_default_to_the_card():
    As, bs, cs = stack_lps(2, 4, 10)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises((RuntimeError, AssertionError)):
        solve_batched(As, bs, cs)


@pytest.mark.parametrize("entry", ["solve_batched", "reoptimize_batched"])
def test_tensors_are_used_in_place(entry, monkeypatch):
    """A stack already on the solve's device goes into the Problem as it is:
    never turned into a host array (no round trip), its storage shared, and
    the answers those of the numpy inputs."""
    from simplex_tpu_torch.batch import vmapped

    seen = []
    inner = vmapped._shadow

    def shadow(prob, options):
        seen.append(prob)
        return inner(prob, options)

    monkeypatch.setattr(vmapped, "_shadow", shadow)
    if entry == "solve_batched":
        arrays = stack_lps(3, 8, 20)
        def call(A, b, c):
            return solve_batched(A, b, c, device="cpu")
    else:
        A, b, c = random_dense_lp(12, 30, seed=31)
        cold = solve(A, b, c, options=SimplexOptions(**OPTS_WARM), device="cpu")
        rng = np.random.default_rng(9)
        bs2 = (np.asarray(b, np.float64) * (1 + 0.2 * rng.uniform(-1, 1, (4, 12)))).astype(np.float32)
        arrays = [A, bs2, c]
        def call(A, b, c):
            return reoptimize_batched(A, b, c, cold, options=SimplexOptions(**OPTS_WARM), device="cpu")
    want = call(*arrays)
    tensors = [torch.from_numpy(v) for v in arrays]

    def no_host_copy(self, *a, **k):
        raise AssertionError("an input tensor was turned into a host array")

    monkeypatch.setattr(torch.Tensor, "__array__", no_host_copy)
    got = call(*tensors)
    monkeypatch.undo()
    prob = seen[-1]
    for field, t in zip("Abc", tensors):
        assert getattr(prob, field).data_ptr() == t.data_ptr(), field
    for field in ("z", "status", "iters", "basis"):
        np.testing.assert_array_equal(getattr(got, field), getattr(want, field))
