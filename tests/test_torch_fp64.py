"""Float64 through the hopper backend: the kernel wrappers and every
single-card entry point under the DEFAULT options with
``SimplexOptions(dtype=torch.float64)``, against the JAX package (its
default backend runs float64 end to end) and HiGHS, on the CPU.

Given CPU tensors a wrapper runs its plain version; the float64 kernels
themselves are held against those plain versions on the card by
``chip_smoke.py``. Here each wrapper is held against its plain version
and ``simplex_tpu.kernels.xla``'s op in float64, mixed float dtypes must
raise, and the JAX suite's float64 scenarios (``tests/test_golden.py``,
``tests/test_corpus.py``: the golden sample, Beale's cycler, the
Klee-Minty ladder, the structured corpus and the MPS fixtures) run
through the port. The batched and sharded modes in float64 under the
hopper backend: ``tests/test_torch_fp64_modes.py``.

Tolerances: indices, flags, pivot counts and bases exactly; the ratio
test's values, eta and x_b bit for bit (the same IEEE float64 ops on both
sides); reduced-cost minima to rtol 1e-12 (float64 sums in another
order); a step's x_b, y, c_b to rtol 1e-10 against the JAX step (the two
ftrans sum in another order); objectives at the JAX tests' own gates
(1e-9 absolute on Beale, 1e-9 relative on Klee-Minty, 1e-6 relative on the
corpus against HiGHS).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

import simplex_tpu
from simplex_tpu.core import step as jstep
from simplex_tpu.core.state import Problem as JaxProblem
from simplex_tpu.core.state import initial_state_slack as jax_slack
from simplex_tpu.core.trace import trace_pivots as jax_trace
from simplex_tpu.kernels import xla as xk
from simplex_tpu.kernels.dispatch import get_backend as jax_backend
from simplex_tpu_torch import (
    GeneralLP,
    SimplexOptions,
    SolveStatus,
    ranging,
    read_mps,
    reoptimize,
    solve,
    solve_batched,
    solve_general,
    solve_with_checkpoints,
    trace_pivots,
)
from simplex_tpu_torch import cli
from simplex_tpu_torch.core.state import state_from_numpy
from simplex_tpu_torch.io.text import load_lp
from simplex_tpu_torch.kernels import _build, hopper
from simplex_tpu_torch.oracle import generator as tgen
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy, solve_scipy_general

F64 = SimplexOptions(dtype=torch.float64)
JF64 = simplex_tpu.SimplexOptions(dtype=jnp.float64)
JB = jax_backend("xla")
DATA = "tests/data"
STEP = dict(rtol=1e-10, atol=1e-12)


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
    return np.random.default_rng(seed).standard_normal(shape)


def t64(a):
    return torch.from_numpy(np.array(a, np.float64))  # a copy: the updates are in place


# --------------------------------------------------------------------------
# the wrappers in float64
# --------------------------------------------------------------------------


@pytest.mark.parametrize("m,n", [(8, 128), (33, 257), (1, 5)])
def test_pricing_scan_f64_matches_plain_and_xla(m, n, no_library):
    y, A, c = rand(m, 1), rand((m, n), 2), rand(n, 3)
    e = np.asarray(xk.reduced_costs(jnp.asarray(y), jnp.asarray(A), jnp.asarray(c)))
    assert e.dtype == np.float64
    eps = 0.5
    got = hopper.pricing_scan(t64(y), t64(A), t64(c), eps)
    want = hopper.pricing_scan_plain(t64(y), t64(A), t64(c), eps)
    assert got[0].dtype == torch.float64 and got[0].dim() == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    np.testing.assert_allclose(float(got[0]), e.min(), rtol=1e-12)
    assert int(got[1]) == int(e.argmin())
    negs = np.nonzero(e < -eps)[0]
    assert int(got[2]) == (int(negs[0]) if len(negs) else hopper.INT_MAX)


@pytest.mark.parametrize("bland", [False, True])
def test_choose_entering_f64_matches_xla(bland, no_library):
    m, n = 16, 200
    y, A, c = rand(m, 4), rand((m, n), 5), rand(n, 6)
    basis = np.random.default_rng(7).permutation(n)[:m].astype(np.int32)
    yj, Aj, cj, bj = (jnp.asarray(v) for v in (y, A, c, basis))
    p_j, min_j = xk.choose_entering(yj, Aj, xk.mask_basic(cj, bj), 1e-9, jnp.asarray(bland))
    p_t, min_t = hopper.choose_entering(
        t64(y), t64(A), t64(c), 1e-9, torch.tensor(bland), torch.from_numpy(basis))
    assert int(p_t) == int(p_j) and min_t.dtype == torch.float64
    np.testing.assert_allclose(float(min_t), float(min_j), rtol=1e-12)
    # the bounded rule's signed pricing: 40% of the columns at their upper
    at_up = np.random.default_rng(8).uniform(size=n) < 0.4
    p_j, min_j = xk.choose_entering_bounded(
        yj, Aj, cj, jnp.asarray(at_up), bj, jnp.asarray(0), 1e-9, jnp.asarray(bland))
    p_t, min_t = hopper.choose_entering_bounded(
        t64(y), t64(A), t64(c), torch.from_numpy(at_up), torch.from_numpy(basis), 0, 1e-9,
        torch.tensor(bland))
    assert int(p_t) == int(p_j)
    np.testing.assert_allclose(float(min_t), float(min_j), rtol=1e-12)


def test_pricing_f64_on_the_bf16_shadow_accumulates_in_f64(no_library):
    # the shadow keeps y and c in float64 and sums in float64 (the plain
    # version upcasts A); a segment view of the shadow is priced in place
    m, n, w = 12, 64, 16
    y, A, c = rand(m, 9), rand((m, n), 10), rand(n, 11)
    Ab = torch.from_numpy(A).to(torch.bfloat16)
    e = y @ Ab.double().numpy() - c
    for lo in (0, 2 * w):
        Av = Ab[:, lo:lo + w]
        min_t, p_t, _ = hopper.pricing_scan(t64(y), Av, t64(c[lo:lo + w]), 1e-9)
        assert min_t.dtype == torch.float64
        np.testing.assert_allclose(float(min_t), e[lo:lo + w].min(), rtol=1e-12)
        assert int(p_t) == int(e[lo:lo + w].argmin())


@pytest.mark.parametrize("harris", [False, True])
@pytest.mark.parametrize("bland", [False, True])
def test_ratio_kernels_f64_match_xla(harris, bland, no_library):
    m = 40
    x_b = np.abs(rand(m, 12))
    x_b[::5] = 0.0  # exact ties at theta = 0
    alpha = rand(m, 13)
    basis = np.random.default_rng(14).permutation(m).astype(np.int32)
    xj, aj, bj = jnp.asarray(x_b), jnp.asarray(alpha), jnp.asarray(basis)
    fn = xk.ratio_argmin_harris if harris else xk.ratio_argmin
    q_j, th_j, unb_j = fn(xj, aj, bj, 1e-7, jnp.asarray(bland))
    flag = torch.tensor(bland)
    xt, at, bt = t64(x_b), t64(alpha), torch.from_numpy(basis)
    q_t, th_t, unb_t, eta, x_new = hopper.ratio_eta(xt, at, bt, 1e-7, flag, harris, 1e-6)
    assert (int(q_t), bool(unb_t)) == (int(q_j), bool(unb_j))
    assert th_t.dtype == torch.float64 and float(th_t) == float(th_j)
    q = int(q_j)
    inv = 1.0 / alpha[q]
    eta_want = -alpha * inv
    eta_want[q] = inv - 1.0
    x_want = x_b - float(th_j) * alpha
    x_want[q] = float(th_j)
    np.testing.assert_array_equal(eta.numpy(), eta_want)
    np.testing.assert_array_equal(x_new.numpy(), x_want)
    for g, w in zip((q_t, th_t, unb_t, eta, x_new),
                    hopper.ratio_eta_plain(xt, at, bt, 1e-7, flag, harris, 1e-6)):
        assert torch.equal(g, w)
    if not harris:
        got = hopper.ratio_argmin(xt, at, bt, 1e-7, flag)
        assert (int(got[0]), float(got[1]), bool(got[2])) == (q, float(th_j), bool(unb_j))
        assert got[1].dtype == torch.float64


def test_rank1_update_f64_matches_xla(no_library):
    m = 9
    B, eta, row = rand((m, m), 15), rand(m, 16), rand(m, 17)
    want = np.asarray(xk.rank1_update(*(jnp.asarray(v) for v in (B, eta, row))))
    Bt = t64(B)
    out = hopper.rank1_update(Bt, t64(eta), t64(row))
    assert out.data_ptr() == Bt.data_ptr()  # in place
    Bp = hopper.rank1_update_plain(t64(B), t64(eta), t64(row))
    assert torch.equal(Bt, Bp)
    # XLA (and a BLAS ger) may fuse the multiply-add: one rounding apart
    np.testing.assert_allclose(Bt.numpy(), want, rtol=1e-15, atol=1e-15)
    # a row block of the inverse (the 2-D solve's)
    blk = t64(B[3:6])
    hopper.rank1_update(blk, t64(eta[3:6]), t64(row))
    assert torch.equal(blk, Bp[3:6])


def test_mixed_float_dtypes_raise(no_library):
    y, A, c = torch.zeros(4, dtype=torch.float64), torch.zeros(4, 8), torch.zeros(8, dtype=torch.float64)
    with pytest.raises(ValueError):
        hopper.pricing_scan(y, A, c, 1e-9)  # float32 A beside float64 vectors
    with pytest.raises(ValueError):
        hopper.pricing_scan(y.float(), A.double(), c, 1e-9)  # float32 y
    x, a, b = torch.zeros(4, dtype=torch.float64), torch.ones(4), torch.arange(4, dtype=torch.int32)
    no = torch.tensor(False)
    for fn in (hopper.ratio_argmin, lambda *args: hopper.ratio_eta(*args, True)):
        with pytest.raises(ValueError):
            fn(x, a, b, 1e-7, no)
        fn(x, a.double(), b, 1e-7, no)  # one dtype passes
    with pytest.raises(ValueError):
        hopper.ratio_eta(x.half(), a.half(), b, 1e-7, no, True)  # neither float32 nor float64
    B = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError):
        hopper.rank1_update(B, torch.ones(4), torch.ones(4, dtype=torch.float64))


def test_f64_output_block_layout():
    # a float64 result sits in two int32 words, 8-byte aligned: the scalar
    # block is q, a pad word, theta_q, then iters, status, degen, npend
    scal = torch.tensor([5, 0, 0, 0, 7, 1, 2, 3], dtype=torch.int32)
    scal[2:4] = torch.tensor([0.25], dtype=torch.float64).view(torch.int32)
    v = hopper._scalar_views(scal, torch.tensor([True, False, True, False]), torch.float64)
    assert (int(v["q"]), int(v["iters"]), int(v["status"]), int(v["degen"]), int(v["npend"])) == (5, 7, 1, 2, 3)
    assert float(v["theta_q"]) == 0.25 and v["theta_q"].dtype == torch.float64 and v["theta_q"].dim() == 0
    assert hopper._scalar_block(torch.device("cpu"), torch.float64).numel() == 8
    assert hopper._scalar_block(torch.device("cpu"), torch.float32).numel() == 6
    out = torch.zeros(5, dtype=torch.int32)
    out[:2] = torch.tensor([-1.5], dtype=torch.float64).view(torch.int32)
    assert float(hopper._value(out, torch.float64)) == -1.5


def tail_args64(m=5):
    g = np.random.default_rng(3)
    f = lambda *s: torch.from_numpy(g.standard_normal(s))  # noqa: E731
    return dict(
        x_b=torch.from_numpy(np.abs(g.standard_normal(m))), alpha=f(m),
        basis=torch.arange(m, dtype=torch.int32), y=f(m), c_b=f(m), B_inv=f(m, m),
        min_e=torch.tensor(-0.5, dtype=torch.float64), e_p=torch.tensor(-0.5, dtype=torch.float64),
        c_p=torch.tensor(0.3, dtype=torch.float64), p=torch.tensor(7, dtype=torch.int32),
        iters=torch.tensor(0, dtype=torch.int32), degen=torch.tensor(0, dtype=torch.int32),
    )


TAIL_KW = dict(eps=1e-9, pivot_tol=1e-7, feas_tol=1e-6, harris=True, degen_tol=1e-9, bland_after=64)


@pytest.mark.parametrize(
    "change",
    [
        dict(y=torch.zeros(5)),  # a float32 vector in a float64 call
        dict(B_inv=torch.eye(5)),
        dict(min_e=torch.tensor(-0.5)),
        dict(c_p=torch.tensor(0.3)),
    ],
)
def test_pivot_tail_f64_rejects_mixed_dtypes(change, no_library):
    t = hopper.pivot_tail(*tail_args64().values(), **TAIL_KW)
    assert t.x_b.dtype == t.eta.dtype == t.theta_q.dtype == torch.float64
    assert t.basis.dtype == torch.int32
    with pytest.raises(ValueError):
        hopper.pivot_tail(*{**tail_args64(), **change}.values(), **TAIL_KW)


@pytest.mark.parametrize(
    "ratio,defer,bland_after,walk",
    [("harris", 0, 64, 3), ("classic", 0, 64, 3), ("harris", 4, 64, 4), ("classic", 0, 2, 7)],
)
def test_pivot_tail_f64_is_the_jax_step(ratio, defer, bland_after, walk, no_library):
    """The tail from a float64 JAX state carried over leaf by leaf: what
    ``simplex_tpu.core.step.pivot_step`` stores from that state."""
    A, b, c = tgen.klee_minty_lp(5) if bland_after == 2 else tgen.random_dense_lp(24, 64, seed=4)
    A, b, c = (np.asarray(v, np.float64) for v in (A, b, c))
    jopts = simplex_tpu.SimplexOptions(dtype=jnp.float64, ratio=ratio, update_defer=defer,
                                       bland_after=bland_after)
    opts = SimplexOptions(dtype=torch.float64, ratio=ratio, update_defer=defer, bland_after=bland_after)
    jp = JaxProblem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    step = jax.jit(lambda p, s: jstep.pivot_step(p, s, jopts, JB))
    js = jax_slack(jp, jnp.float64, update_defer=jopts.resolve_defer(), perturb=False)
    for _ in range(walk):
        js = step(jp, js)
    if bland_after == 2:
        js = js._replace(degen=jnp.asarray(5, jnp.int32))  # Bland's rule on
    keys = ["B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen", "last_refac"]
    if defer:
        keys += ["U", "R", "npend"]
    ts = state_from_numpy({k: np.asarray(getattr(js, k)) for k in keys} | {"pert": None}, "cpu")
    assert ts.B_inv.dtype == ts.x_b.dtype == torch.float64
    eps = opts.resolve_eps()
    use_bland = jnp.asarray(int(js.degen) >= bland_after)
    p_j, min_j = JB.choose_entering(js.y, jp.A, JB.mask_basic(jp.c, js.basis), eps, use_bland)
    p = int(p_j)
    alpha = np.asarray(js.B_inv) @ A[:, p]
    extra = {}
    if defer:
        alpha = alpha + np.asarray(js.U).T @ (np.asarray(js.R) @ A[:, p])
        extra = dict(U=ts.U, R=ts.R, npend=int(js.npend), npend_t=ts.npend)
    e_p = np.asarray(js.y) @ A[:, p] - c[p]
    t = hopper.pivot_tail(
        ts.x_b, t64(alpha), ts.basis, ts.y, ts.c_b, ts.B_inv, torch.tensor(float(min_j), dtype=torch.float64),
        torch.tensor(e_p, dtype=torch.float64), torch.tensor(c[p], dtype=torch.float64),
        torch.tensor(p, dtype=torch.int32), ts.iters, ts.degen, eps=eps, pivot_tol=opts.pivot_tol,
        feas_tol=opts.feas_tol, harris=ratio == "harris", degen_tol=opts.degen_tol,
        bland_after=bland_after, **extra,
    )
    js1 = step(jp, js)
    np.testing.assert_array_equal(t.basis.numpy(), np.asarray(js1.basis))
    for f in ("status", "iters", "degen"):
        assert int(getattr(t, f)) == int(getattr(js1, f)), f
    assert bool(t.take)
    for f in ("x_b", "y", "c_b"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(js1, f)), err_msg=f, **STEP)


# --------------------------------------------------------------------------
# the JAX suite's float64 scenarios under the default options
# --------------------------------------------------------------------------


def test_golden_sample_f64():
    A, b, c = load_lp(os.path.join(DATA, "sample.txt"), dtype=np.float64)
    res = solve(A, b, c, options=F64, device="cpu")
    ref = simplex_tpu.solve(A, b, c, options=JF64)
    assert res.status == SolveStatus.OPTIMAL and res.z == 9.0
    np.testing.assert_array_equal(res.x, [1.0, 3.0, 0.0, 0.0])
    assert res.x.dtype == np.float64 and res.iters == ref.iters == 2


@pytest.mark.parametrize("ratio", ["harris", "classic"])
def test_beale_cycler_f64(ratio):
    A, b, c = tgen.beale_cycling_lp()
    res = solve(A, b, c, options=SimplexOptions(dtype=torch.float64, ratio=ratio, bland_after=8), device="cpu")
    ref = simplex_tpu.solve(A, b, c, options=simplex_tpu.SimplexOptions(
        dtype=jnp.float64, ratio=ratio, bland_after=8))
    assert res.status == SolveStatus.OPTIMAL
    assert abs(res.z - 0.05) < 1e-9
    assert res.iters == ref.iters


@pytest.mark.parametrize("n", [4, 6, 8])
def test_klee_minty_ladder_f64(n):
    A, b, c = tgen.klee_minty_lp(n)
    z_ref = solve_scipy(A, b, c).z
    assert abs(z_ref - 5.0 ** n) < 1e-6 * 5.0 ** n
    pivots, jax_pivots = {}, {}
    for pricing in ("dantzig", "devex", "steepest"):
        res = solve(A, b, c, options=SimplexOptions(dtype=torch.float64, ratio="classic", pricing=pricing),
                    device="cpu")
        assert res.status == SolveStatus.OPTIMAL, pricing
        assert abs(res.z - z_ref) < 1e-9 * z_ref, pricing
        pivots[pricing] = res.iters
        if n == 6:
            jax_pivots[pricing] = simplex_tpu.solve(A, b, c, options=simplex_tpu.SimplexOptions(
                dtype=jnp.float64, ratio="classic", pricing=pricing)).iters
    assert pivots["dantzig"] == 2 ** n - 1 and pivots["steepest"] == 1, pivots
    assert pivots["devex"] < pivots["dantzig"], pivots
    assert not jax_pivots or jax_pivots == pivots


def mps_general(name):
    prob = read_mps(os.path.join(DATA, name))
    c = prob.c if prob.maximize else -prob.c
    return prob, GeneralLP(A=prob.A, b=prob.b, c=c, row_types=prob.row_types,
                           lower=prob.lower, upper=prob.upper)


CORPUS = {
    "transport_balanced_4x3": lambda: tgen.transportation_lp(4, 3, seed=0, balanced=True),
    "transport_balanced_8x6": lambda: tgen.transportation_lp(8, 6, seed=2, balanced=True),
    "transport_unbalanced": lambda: tgen.transportation_lp(5, 4, seed=3, balanced=False),
    "assignment_6": lambda: tgen.assignment_lp(6, seed=1),
    "production": lambda: tgen.production_lp(12, 6, seed=1),
    "transport_64x48": lambda: tgen.transportation_lp(64, 48, seed=11, balanced=False),
    "assignment_32": lambda: tgen.assignment_lp(32, seed=12),
    "production_512x128": lambda: tgen.production_lp(512, 128, seed=13),
    "multiperiod_32x16": lambda: tgen.multiperiod_production_lp(32, 16, seed=0),
    **{f: (lambda f=f: mps_general(f)[1]) for f in (
        "multiperiod16x8.mps", "prod_bounded.mps", "blend_ranges.mps", "transport2x3.mps", "freevar_mi.mps")},
}


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_corpus_f64_against_highs(name):
    lp = CORPUS[name]()
    res = solve_general(lp, options=F64, device="cpu")
    ref = solve_scipy_general(lp)
    assert res.status == ref.status, (res.status, ref.status)
    if ref.status == SolveStatus.OPTIMAL:
        assert relative_gap(res.z, ref.z) < 1e-6, (res.z, ref.z)
    if name.startswith("assignment"):
        k = int(round(np.sqrt(len(res.x))))
        x = np.round(res.x.reshape(k, k))
        assert np.all(x.sum(axis=0) == 1) and np.all(x.sum(axis=1) == 1)
    if name == "multiperiod_32x16":
        assert res.phase1_iters >= 512
    if name == "transport2x3.mps":
        assert abs(-res.z - 41.0) < 1e-9
    if name == "prod_bounded.mps":
        assert abs(res.x[3] - 2.5) < 1e-9 and res.x[1] >= 1 - 1e-9


def test_corpus_f64_against_jax_on_the_fixture():
    from simplex_tpu.core import twophase as jtp

    _, lp = mps_general("blend_ranges.mps")
    res = solve_general(lp, options=F64, device="cpu")
    ref = jtp.solve_general(jtp.GeneralLP(A=lp.A, b=lp.b, c=lp.c, row_types=lp.row_types,
                                          lower=lp.lower, upper=lp.upper), options=JF64)
    assert res.status == ref.status == SolveStatus.OPTIMAL
    assert relative_gap(res.z, ref.z) < 1e-9
    presolved = solve_general(lp, options=F64, presolve=True, device="cpu")
    assert relative_gap(presolved.z, ref.z) < 1e-9


def test_warm_restarts_and_ranging_f64():
    A, b, c = tgen.random_dense_lp(16, 40, seed=21, dtype=np.float64)
    A, b, c = (np.asarray(v, np.float64) for v in (A, b, c))
    res = solve(A, b, c, options=F64, device="cpu")
    jres = simplex_tpu.solve(A, b, c, options=JF64)
    assert res.status == SolveStatus.OPTIMAL and relative_gap(res.z, jres.z) < 1e-12
    np.testing.assert_array_equal(np.sort(res.basis), np.sort(np.asarray(jres.basis)))
    # the same basis in both packages, in the same order
    rg = ranging(A, b, c, np.array(jres.basis), device="cpu")
    jrg = simplex_tpu.ranging(A, b, c, jres.basis)
    assert rg.ok
    # ranging runs in float32 in both packages, whatever the solve's dtype:
    # tests/test_torch_analysis.py's comparison, where a range beyond 1e5
    # (b is O(1) here) comes from an entry at the float32 noise floor
    for f in ("b_lo", "b_hi", "y", "x"):
        g, w = np.asarray(getattr(rg, f), np.float64), np.asarray(getattr(jrg, f), np.float64)
        big = (np.abs(w) > 1e5) | ~np.isfinite(w)
        np.testing.assert_array_equal(np.sign(g[big]), np.sign(w[big]), err_msg=f)
        np.testing.assert_allclose(g[~big], w[~big], rtol=1e-4, atol=1e-5, err_msg=f)
    b2 = b.copy()
    b2[3] *= 1.5
    warm = reoptimize(A, b2, c, res, options=F64, device="cpu")
    jwarm = simplex_tpu.reoptimize(A, b2, c, jres, options=JF64)
    assert warm.status == jwarm.status
    if jwarm.status == SolveStatus.OPTIMAL:
        assert relative_gap(warm.z, jwarm.z) < 1e-10
        assert relative_gap(warm.z, solve_scipy(A, b2, c).z) < 1e-9


def test_trace_pivots_f64_matches_jax():
    A, b, c = tgen.random_dense_lp(8, 20, seed=13, dtype=np.float64)
    A, b, c = (np.asarray(v, np.float64) for v in (A, b, c))
    recs = list(trace_pivots(A, b, c, options=F64, device="cpu"))
    want = list(jax_trace(A, b, c, options=JF64))
    assert len(recs) == len(want)
    for g, w in zip(recs, want):
        assert (g.entering, g.leaving_row, g.leaving) == (w.entering, w.leaving_row, w.leaving)
        np.testing.assert_array_equal(g.basis, np.asarray(w.basis))
        assert g.objective == pytest.approx(w.objective, rel=1e-10, abs=1e-12)
    assert recs[-1].status == SolveStatus.OPTIMAL


def test_checkpointed_solve_f64_matches_jax(tmp_path):
    from simplex_tpu.core import checkpoint as jck

    A, b, c = tgen.random_dense_lp(24, 60, seed=8, dtype=np.float64)
    A, b, c = (np.asarray(v, np.float64) for v in (A, b, c))
    opts = SimplexOptions(dtype=torch.float64, checkpoint_every=5)
    res = solve_with_checkpoints(A, b, c, path=tmp_path / "p.npz", options=opts, device="cpu")
    ref = jck.solve_with_checkpoints(A, b, c, path=tmp_path / "j.npz", options=simplex_tpu.SimplexOptions(
        dtype=jnp.float64, checkpoint_every=5))
    assert res.status == SolveStatus.OPTIMAL
    assert res.z == pytest.approx(ref.z, rel=1e-12) and res.iters == ref.iters


def test_sparse_a_f64():
    A, b, c = tgen.random_dense_lp(20, 50, seed=5, dtype=np.float64)
    A, b, c = (np.asarray(v, np.float64) for v in (A, b, c))
    dense = solve(A, b, c, options=F64, device="cpu")
    sparse = solve(sps.csr_matrix(A), b, c, options=F64, device="cpu")
    assert dense.status == sparse.status == SolveStatus.OPTIMAL
    assert relative_gap(sparse.z, dense.z) < 1e-12
    assert relative_gap(dense.z, solve_scipy(A, b, c).z) < 1e-9


def test_cli_fp64_under_the_default_backend(capsys):
    rc = cli.main(["solve", os.path.join(DATA, "sample.txt"), "--fp64", "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and out.startswith("Optimum found: 9\n") and "Pivots: 2" in out


# --------------------------------------------------------------------------
# the batched mode under the plain ops (the kernels' float64 runs: tests/test_torch_fp64_modes.py)
# --------------------------------------------------------------------------


def test_batched_f64_under_the_torch_backend_runs():
    A, b, c = tgen.random_dense_lp(6, 14, seed=2)
    opts = SimplexOptions(dtype=torch.float64, backend="torch")
    out = solve_batched(A[None], b[None], c[None], options=opts, device="cpu")
    assert SolveStatus(int(out.status[0])) == SolveStatus.OPTIMAL
    assert relative_gap(float(out.z[0]), solve(A, b, c, options=opts, device="cpu").z) < 1e-9
