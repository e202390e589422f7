"""The flagship option set of the port (bf16 pricing shadow, segmented
pricing, deferred rank-L updates, multiple pricing) against the JAX
package's, one pivot step from the same state and whole solves.

States carry across with ``state_from_numpy``, deferred buffers and the
candidate buffer included. Solves mirror the single-device cases of
``tests/test_mixed_pricing.py``, ``test_deferred_update.py`` and
``test_multi_pricing.py``: status and z against ``simplex_tpu.solve`` and
HiGHS. The two packages may walk different paths (the port's shadow pricing
keeps y in fp32 where ``kernels/xla.py`` rounds it to bf16; torch.topk and
approx_max_k order ties differently), so solves compare answers, not paths.

Tolerances: indices, flags and counts exactly; B_inv, U, R, x_b, y and the
candidate columns to rtol / atol 1e-5 after one step (fp32 products that
sum in another order); z to rel gap 1e-5 (the fp32 gate), 1e-4 where the
JAX test of the same case allows it (degenerate instances under Bland).
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
from simplex_tpu.core.state import initial_state_slack as jax_slack
from simplex_tpu.kernels.dispatch import get_backend as jax_backend
from simplex_tpu.oracle.generator import beale_cycling_lp, random_dense_lp
from simplex_tpu.oracle.reference import relative_gap, solve_scipy
from simplex_tpu_torch import SimplexOptions, SolveStatus, load_lp, solve
from simplex_tpu_torch.core import step
from simplex_tpu_torch.core.solver import solve_state
from simplex_tpu_torch.core.state import (
    Problem,
    initial_state_slack,
    problem_from_numpy,
    state_from_numpy,
    with_pricing_shadow,
)
from simplex_tpu_torch.kernels.dispatch import get_backend

JB = jax_backend("xla")
SAMPLE = "tests/data/sample.txt"
SIZES = [(4, 10), (16, 40), (48, 120)]
FLAGSHIP = dict(pricing_dtype="bfloat16", partial_pricing=8, update_defer=16, multi_price=64)


def leaves(s):
    """A JAX SolverState's leaves as host arrays, with the deferred and
    candidate buffers."""
    d = {
        f: np.asarray(getattr(s, f))
        for f in (
            "B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen",
            "last_refac", "U", "R", "npend",
        )
    }
    d["cand"] = None if s.cand is None else tuple(np.asarray(v) for v in s.cand)
    d["pert"] = None if s.pert is None else tuple(np.asarray(v) for v in s.pert)
    return d


def problems(A, b, c):
    A, b, c = (np.asarray(v, np.float32) for v in (A, b, c))
    return JaxProblem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c)), problem_from_numpy(
        A, b, c, "cpu"
    )


def close(t, j, what, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol, err_msg=what)


def assert_same(ts, js):
    np.testing.assert_array_equal(ts.basis.numpy(), np.asarray(js.basis))
    for f in ("status", "iters", "degen", "npend"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    for f in ("B_inv", "x_b", "y", "c_b", "U", "R"):
        close(getattr(ts, f), getattr(js, f), f)


def walk(jp, jopts, k):
    """The JAX state after k pivot steps with ``jopts`` from the slack basis."""
    fn = jax.jit(lambda p, s: jstep.pivot_step(p, s, jopts, JB))
    js = jax_slack(
        jp, jnp.float32, update_defer=jopts.resolve_defer(),
        multi_price=jopts.multi_price, perturb=True,
    )
    for _ in range(k):
        js = fn(jp, js)
    return js, fn


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("k", [0, 2, 3, 7])
def test_deferred_step_matches_jax(backend, k):
    # k = 3 and 7 leave 3 pairs pending: the step appends the fourth and
    # flushes B_inv += U.T R
    L = 4
    jp, tp = problems(*random_dense_lp(24, 60, seed=3))
    js, fn = walk(jp, JaxOptions(update_defer=L), k)
    assert int(js.status) == SolveStatus.RUNNING and int(js.npend) == k % L
    ts = state_from_numpy(leaves(js), "cpu")
    js1 = fn(jp, js)
    ts1 = step.pivot_step(tp, ts, SimplexOptions(update_defer=L, backend=backend), get_backend(backend))
    assert int(ts1.iters) == k + 1
    assert_same(ts1, js1)
    true_t = ts1.B_inv + ts1.U.T @ ts1.R
    true_j = js1.B_inv + js1.U.T @ js1.R
    close(true_t, true_j, "B_inv + U.T R")
    B = np.asarray(jp.A)[:, np.asarray(js1.basis)].astype(np.float64)
    np.testing.assert_allclose(true_t.double().numpy() @ B, np.eye(24), atol=1e-4)


def by_index(cand):
    """Candidate rows keyed by column index (the two top-k may order them
    differently)."""
    idx = np.asarray(cand.idx)
    order = np.argsort(idx, kind="stable")
    return idx[order], order


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("k", [0, 5, 9])
def test_multi_price_refill_step_matches_jax(backend, k):
    # an emptied buffer forces the refill: one exact pricing pass, top-K,
    # a flush when 4 pairs are pending, one (m, m) x (m, K) ftran
    K = 4
    jp, tp = problems(*random_dense_lp(24, 60, seed=6))
    js, fn = walk(jp, JaxOptions(multi_price=K), k)
    js = js._replace(cand=js.cand._replace(valid=jnp.zeros_like(js.cand.valid)))
    ts = state_from_numpy(leaves(js), "cpu")
    js1 = fn(jp, js)
    ts1 = step.pivot_step(tp, ts, SimplexOptions(multi_price=K, backend=backend), get_backend(backend))
    assert_same(ts1, js1)
    idx_t, o_t = by_index(ts1.cand)
    idx_j, o_j = by_index(js1.cand)
    np.testing.assert_array_equal(idx_t, idx_j)
    for f in ("alpha", "acols", "e"):
        close(getattr(ts1.cand, f)[torch.from_numpy(o_t)], np.asarray(getattr(js1.cand, f))[o_j], f)
    np.testing.assert_array_equal(ts1.cand.valid.numpy()[o_t], np.asarray(js1.cand.valid)[o_j])
    assert int(ts1.cand.seg) == int(js1.cand.seg) == int(js.cand.seg) + 1
    np.testing.assert_allclose(float(ts1.cand.e0), float(js1.cand.e0), rtol=1e-5)


def test_multi_price_minor_step_matches_jax():
    # a step from a live buffer: no refill, the entering column rebuilt
    # from its base ftran and the pending pairs
    K = 8
    jp, tp = problems(*random_dense_lp(24, 60, seed=6))
    js, fn = walk(jp, JaxOptions(multi_price=K), 3)
    ts = state_from_numpy(leaves(js), "cpu")
    assert not step.read_control(ts, SimplexOptions(multi_price=K)).need_refill
    js1 = fn(jp, js)
    ts1 = step.pivot_step(tp, ts, SimplexOptions(multi_price=K), get_backend("hopper"))
    assert_same(ts1, js1)
    np.testing.assert_array_equal(ts1.cand.valid.numpy(), np.asarray(js1.cand.valid))
    close(ts1.cand.e, js1.cand.e, "e")


def check_solve(A, b, c, tol=1e-5, dtype=torch.float32, **opts):
    """The port's solve against simplex_tpu.solve and HiGHS, same options."""
    res = solve(A, b, c, options=SimplexOptions(dtype=dtype, **opts), device="cpu")
    jdtype = jnp.float64 if dtype == torch.float64 else jnp.float32
    ref_jax = simplex_tpu.solve(A, b, c, options=JaxOptions(dtype=jdtype, **opts))
    ref = solve_scipy(A, b, c)
    assert res.status == SolveStatus.OPTIMAL == int(ref_jax.status) == ref.status
    assert relative_gap(res.z, ref.z) <= tol
    assert relative_gap(res.z, ref_jax.z) <= tol
    return res


# ---- mixed-precision (bf16) pricing: tests/test_mixed_pricing.py ----


@pytest.mark.parametrize("m,n", SIZES)
def test_bf16_pricing_matches_oracle(m, n):
    A, b, c = random_dense_lp(m, n, seed=5)
    res = check_solve(A, b, c, pricing_dtype="bfloat16", refactor_every=64)
    np.testing.assert_allclose(A @ res.x, b, atol=1e-3)
    assert np.all(res.x >= -1e-4)


@pytest.mark.parametrize(
    "opts",
    [
        dict(pricing_dtype="bfloat16"),
        dict(update_defer=4),
        dict(multi_price=2),
        FLAGSHIP,
    ],
)
def test_golden_sample(opts):
    A, b, c = load_lp(SAMPLE)
    res = solve(A, b, c, options=SimplexOptions(**opts), device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    assert abs(res.z - 9.0) < 1e-5
    np.testing.assert_allclose(res.x[:2], [1.0, 3.0], atol=1e-5)


@pytest.mark.parametrize(
    "opts",
    [
        dict(pricing_dtype="bfloat16"),
        dict(update_defer=4),
        dict(multi_price=8),
        dict(FLAGSHIP, partial_min_segment=4),
    ],
)
def test_degenerate_bland_terminates(opts):
    # Bland's rule needs exact first-eligible pricing: the shadow, segment
    # and candidate paths must route its pivots through the exact pass
    A, b, c = random_dense_lp(24, 60, seed=11, degenerate=True)
    check_solve(A, b, c, tol=1e-4, bland_after=8, refactor_every=32, **opts)


@pytest.mark.parametrize(
    "opts",
    [
        dict(pricing_dtype="bfloat16"),
        dict(update_defer=4),
        dict(multi_price=2),
        FLAGSHIP,
    ],
)
def test_unbounded_detected(opts):
    A = np.array([[1.0, -1.0, 1.0]], np.float32)
    b = np.array([1.0], np.float32)
    c = np.array([1.0, 1.0, 0.0], np.float32)
    res = solve(A, b, c, options=SimplexOptions(**opts), device="cpu")
    ref = simplex_tpu.solve(A, b, c, options=JaxOptions(**opts))
    assert res.status == SolveStatus.UNBOUNDED == int(ref.status)


def test_bf16_shadow_attached_only_when_requested():
    prob = Problem(torch.ones(2, 4), torch.ones(2), torch.ones(4))
    assert with_pricing_shadow(prob, "float32").A_price is None
    assert with_pricing_shadow(prob, "bfloat16", pricing="devex").A_price is None
    shadow = with_pricing_shadow(prob, "bfloat16").A_price
    assert shadow.dtype == torch.bfloat16 and shadow.shape == prob.A.shape


@pytest.mark.parametrize("pricing_dtype", ["float32", "bfloat16"])
def test_partial_pricing_matches_oracle(pricing_dtype):
    # n / S = 512: the segmented path is active at the default gate
    A, b, c = random_dense_lp(16, 2048, seed=19)
    res = check_solve(A, b, c, partial_pricing=4, pricing_dtype=pricing_dtype, refactor_every=32)
    assert len(np.unique(res.basis)) == len(res.basis)


def test_partial_pricing_non_divisible_falls_back():
    A, b, c = random_dense_lp(16, 41, seed=20)
    check_solve(A, b, c, partial_pricing=4)


def test_partial_pricing_small_segment_guard():
    small = Problem(torch.ones(4, 40), torch.ones(4), torch.ones(40))
    big = Problem(torch.ones(4, 4096), torch.ones(4), torch.ones(4096))
    opts = SimplexOptions(partial_pricing=8)
    assert not step._partial_active(opts, small)
    assert step._partial_active(opts, big)


def test_partial_pricing_unbounded():
    rng = np.random.default_rng(5)
    m, n = 2, 2048
    A = rng.uniform(0.1, 1.0, (m, n)).astype(np.float32)
    A[:, 5] = [-1.0, -0.5]  # a column that can grow without bound
    A[:, n - m :] = np.eye(m, dtype=np.float32)
    b = np.array([1.0, 2.0], np.float32)
    c = np.zeros(n, np.float32)
    c[5] = 1.0
    res = solve(A, b, c, options=SimplexOptions(partial_pricing=2), device="cpu")
    ref = simplex_tpu.solve(A, b, c, options=JaxOptions(partial_pricing=2))
    assert res.status == SolveStatus.UNBOUNDED == int(ref.status)


def test_segment_fallback_reads_counted():
    # segmented pricing decides its fallback on the host: one counted read
    # per pivot for the recheck, more only when a segment is dry
    A, b, c = random_dense_lp(16, 2048, seed=19)
    step.reset_host_reads()
    res = solve(A, b, c, options=SimplexOptions(partial_pricing=4), device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    assert step.host_reads["branch"] >= res.iters


# ---- deferred rank-L updates: tests/test_deferred_update.py ----


@pytest.mark.parametrize("L", [1, 3, 8])
@pytest.mark.parametrize("m,n", SIZES)
def test_defer_matches_oracle(L, m, n):
    A, b, c = random_dense_lp(m, n, seed=2)
    check_solve(A, b, c, update_defer=L, refactor_every=64)


@pytest.mark.parametrize("L", [2, 5])
def test_defer_matches_eager_path(L):
    # the telescoped product form is exact: in f64 the deferred walk takes
    # the eager walk's pivots and ends at its basis
    A, b, c = random_dense_lp(12, 30, seed=9, dtype=np.float64)
    # backend="torch": the CUDA kernels are fp32
    opts = dict(dtype=torch.float64, verify_terminal=False, backend="torch")
    eager = solve(A, b, c, options=SimplexOptions(**opts), device="cpu")
    lazy = solve(A, b, c, options=SimplexOptions(update_defer=L, **opts), device="cpu")
    ref = simplex_tpu.solve(
        A, b, c, options=JaxOptions(dtype=jnp.float64, update_defer=L, verify_terminal=False)
    )
    assert lazy.status == eager.status == SolveStatus.OPTIMAL == int(ref.status)
    assert lazy.iters == eager.iters == ref.iters
    np.testing.assert_array_equal(lazy.basis, eager.basis)
    np.testing.assert_allclose(lazy.x_b, eager.x_b, rtol=1e-9, atol=1e-12)


def test_defer_state_materializes_true_inverse():
    # k < L pivots leave pairs pending: B_inv + U.T R is the true inverse
    A, b, c = random_dense_lp(10, 24, seed=4, dtype=np.float64)
    opts = SimplexOptions(
        dtype=torch.float64, update_defer=16, verify_terminal=False, backend="torch"
    )
    prob = problem_from_numpy(A, b, c, "cpu", torch.float64)
    s0 = initial_state_slack(prob, torch.float64, update_defer=16)
    final = solve_state(prob, s0, opts, max_iter=5)
    k = int(final.npend)
    assert 0 < k <= 5
    B_true = (final.B_inv + final.U.T @ final.R).numpy()
    np.testing.assert_allclose(B_true, np.linalg.inv(A[:, final.basis.numpy()]), rtol=1e-8, atol=1e-10)


def test_defer_with_bf16_pricing():
    A, b, c = random_dense_lp(32, 80, seed=6)
    check_solve(A, b, c, update_defer=4, pricing_dtype="bfloat16", refactor_every=48)


def test_refactorize_and_recompute_fold_pending_pairs():
    # both packages' refactorize / recompute_xy from one state with pairs
    # pending and a live candidate buffer
    jp, tp = problems(*random_dense_lp(20, 50, seed=5))
    js, _ = walk(jp, JaxOptions(multi_price=4), 6)
    assert int(js.npend) > 0
    ts = state_from_numpy(leaves(js), "cpu")
    be = get_backend("torch")
    jr, tr = jstep.refactorize(jp, js, JB, defer=True), step.refactorize(tp, ts, be, defer=True)
    assert int(tr.npend) == int(jr.npend) == 0 and float(tr.U.abs().max()) == 0.0
    assert not tr.cand.valid.any() and not np.asarray(jr.cand.valid).any()
    for f in ("B_inv", "x_b", "y"):
        close(getattr(tr, f), getattr(jr, f), f, rtol=1e-4)
    jx, tx = jstep.recompute_xy(jp, js, True), step.recompute_xy(tp, ts, True)
    close(tx.x_b, jx.x_b, "x_b")
    close(tx.y, jx.y, "y")
    assert not tx.cand.valid.any()


# ---- multiple pricing: tests/test_multi_pricing.py ----


@pytest.mark.parametrize("K", [1, 4, 16])
@pytest.mark.parametrize("m,n", SIZES)
def test_multi_price_matches_oracle(m, n, K):
    A, b, c = random_dense_lp(m, n, seed=7)
    res = check_solve(A, b, c, multi_price=K, refactor_every=64)
    np.testing.assert_allclose(A @ res.x, b, atol=1e-3)
    assert np.all(res.x >= -1e-4)


def test_multi_price_k_larger_than_n_clamps():
    A, b, c = random_dense_lp(4, 10, seed=9)
    check_solve(A, b, c, multi_price=64)
    prob = problem_from_numpy(A, b, c, "cpu")
    assert initial_state_slack(prob, torch.float32, multi_price=64).cand.idx.shape == (10,)


def test_multi_price_beale_cycling_terminates():
    A, b, c = beale_cycling_lp()
    res = solve(A, b, c, options=SimplexOptions(multi_price=4, bland_after=16), device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    assert abs(res.z - 0.05) < 1e-6


@pytest.mark.parametrize("pricing_dtype", ["float32", "bfloat16"])
def test_multi_price_with_shadow_and_defer(pricing_dtype):
    A, b, c = random_dense_lp(32, 96, seed=13)
    check_solve(
        A, b, c, multi_price=8, pricing_dtype=pricing_dtype, update_defer=4, refactor_every=32
    )


def test_multi_price_pivot_path_sanity():
    A, b, c = random_dense_lp(32, 512, seed=29)
    base = solve(A, b, c, options=SimplexOptions(refactor_every=64), device="cpu")
    multi = solve(A, b, c, options=SimplexOptions(multi_price=16, refactor_every=64), device="cpu")
    assert multi.status == base.status == SolveStatus.OPTIMAL
    assert multi.iters <= 4 * max(base.iters, 8)


@pytest.mark.parametrize("pricing_dtype", ["float32", "bfloat16"])
def test_multi_price_segmented_refills(pricing_dtype):
    # partial_min_segment lowered so the segment gate opens at test scale
    A, b, c = random_dense_lp(16, 64, seed=31)
    res = check_solve(
        A, b, c, multi_price=4, partial_pricing=4, partial_min_segment=4,
        pricing_dtype=pricing_dtype, update_defer=4, refactor_every=32,
    )
    np.testing.assert_allclose(A @ res.x, b, atol=1e-3)


def test_multi_price_segment_gate_requires_shadow():
    A, b, c = random_dense_lp(12, 48, seed=35)
    check_solve(A, b, c, multi_price=4, partial_pricing=4, partial_min_segment=4)


# ---- all four together ----


@pytest.mark.parametrize("backend", ["hopper", "torch"])
@pytest.mark.parametrize("m,n,seed", [(16, 64, 0), (32, 256, 1), (64, 512, 2)])
def test_flagship_matches_jax_and_highs(backend, m, n, seed):
    # bench.py's option set, with segments small enough to be active here
    A, b, c = random_dense_lp(m, n, seed=seed)
    opts = dict(FLAGSHIP, partial_min_segment=8, refactor_every=2048)
    res = solve(A, b, c, options=SimplexOptions(backend=backend, **opts), device="cpu")
    ref_jax = simplex_tpu.solve(A, b, c, options=JaxOptions(**opts))
    ref = solve_scipy(A, b, c)
    assert res.status == SolveStatus.OPTIMAL == int(ref_jax.status)
    assert relative_gap(res.z, ref.z) <= 1e-5
    assert relative_gap(res.z, ref_jax.z) <= 1e-5
    assert res.feas_err <= 1e-6
