"""The batched pricing rules of the port against the JAX package's.

``solve_batched`` and ``reoptimize_batched`` under devex, steepest edge and
segmented Dantzig (``partial_pricing``, with ``partial_min_segment``
lowered so that segments of a few columns are on) against
``simplex_tpu.batch.vmapped`` (xla backend), on the CPU at the sizes of
``tests/test_torch_batch.py``: statuses equal instance by instance and z
within a relative 1e-5 (1e-4 under bounds and for the warm re-solves, the
JAX tests' own bars, ``tests/test_bounded_pricing.py:133``); one batched
step from a carried vmapped JAX state, e and gamma included, leaf by leaf
(rtol / atol 1e-5: fp32 sums in another order); the maintained weights
against the exact norms 1 + |B_inv A_j|^2 in float64 (rtol 1e-8, as
``tests/test_bounded_pricing.py`` pins them); the windowed pricing twin
against the single op on each instance's slice. Both backends run: the
hopper wrappers take their plain twins on CPU tensors.
"""

import logging

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from simplex_tpu import solve as jax_solve
from simplex_tpu.batch.vmapped import reoptimize_batched as jax_reoptimize_batched
from simplex_tpu.batch.vmapped import solve_batched as jax_solve_batched
from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.oracle.generator import random_dense_lp
from simplex_tpu.oracle.reference import relative_gap, solve_scipy
from simplex_tpu_torch import SimplexOptions, SolveStatus, solve
from simplex_tpu_torch.batch import step as bstep
from simplex_tpu_torch.batch.vmapped import reoptimize_batched, solve_batched
from simplex_tpu_torch.core import step as sstep
from simplex_tpu_torch.core.state import Problem, initial_state_slack, problem_from_numpy
from simplex_tpu_torch.kernels import dispatch, hopper, ops
from simplex_tpu_torch.logging import get_logger
from simplex_tpu_torch.sparse import from_scipy
from tests.test_torch_batch import bounded_stack, carried, jax_batch_walk, stack_lps

BACKENDS = ["torch", "hopper"]
SEG = dict(partial_pricing=4, partial_min_segment=4)
# each rule's options, as both packages take them
RULES = {
    "devex": dict(pricing="devex"),
    "steepest": dict(pricing="steepest"),
    "devex defer": dict(pricing="devex", update_defer=4),
    "steepest defer": dict(pricing="steepest", update_defer=4),
    "segments": SEG,
    "segments bf16": dict(SEG, pricing_dtype="bfloat16"),
    "segments bf16 no shadow fallback": dict(SEG, pricing_dtype="bfloat16", fallback_shadow=False),
    "segments defer": dict(SEG, update_defer=4),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread (the suite's workers share the cores)."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _instances(B=6, m=12, n=32):
    return stack_lps(B, m, n)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("rule", list(RULES))
def test_solve_batched_rules_match_jax(backend, rule):
    As, bs, cs = _instances()
    opts = RULES[rule]
    res = solve_batched(As, bs, cs, options=SimplexOptions(backend=backend, **opts), device="cpu")
    jres = jax_solve_batched(As, bs, cs, options=JaxOptions(**opts))
    np.testing.assert_array_equal(res.status, jres.status)
    for i in range(As.shape[0]):
        assert SolveStatus(int(res.status[i])) == SolveStatus.OPTIMAL
        assert relative_gap(float(res.z[i]), float(jres.z[i])) < 1e-5, i
        assert relative_gap(float(res.z[i]), solve_scipy(As[i], bs[i], cs[i]).z) < 1e-5, i


@pytest.mark.parametrize("rule", ["devex", "steepest", "steepest defer", "segments", "segments bf16"])
def test_bounded_rules_match_jax(rule):
    """Bounds u shared by the batch (``tests/test_bounded_pricing.py``'s
    batched case): the signed pick and its recheck; 1e-4 as JAX's bar."""
    As, bs, cs, u = bounded_stack()
    opts = RULES[rule]
    res = solve_batched(As, bs, cs, u=u, options=SimplexOptions(**opts), device="cpu")
    jres = jax_solve_batched(As, bs, cs, u=u, options=JaxOptions(**opts))
    np.testing.assert_array_equal(res.status, jres.status)
    for i in range(As.shape[0]):
        single = solve(As[i], bs[i], cs[i], u=u, options=SimplexOptions(**opts), device="cpu")
        assert SolveStatus(int(res.status[i])) == single.status == SolveStatus.OPTIMAL
        assert relative_gap(float(res.z[i]), single.z) < 1e-4, i
        assert relative_gap(float(res.z[i]), float(jres.z[i])) < 1e-4, i


@pytest.mark.parametrize("rule", ["devex", "steepest", "segments"])
def test_finished_and_running_instances_mix(rule):
    """An unbounded instance among optimal ones, and a pivot limit that
    leaves some instances running out: statuses and pivot counts equal
    JAX's instance by instance."""
    B, m, n = 4, 2, 8
    As, bs, cs = stack_lps(B, m, n)
    As[2] = np.array([[-1, -1, 0, 0, 0, 0, 1, 0], [-2, -1, 0, 0, 0, 0, 0, 1]], np.float32)
    cs[2] = np.array([1, 0, 0, 0, 0, 0, 0, 0], np.float32)
    opts = dict(RULES[rule], partial_min_segment=2) if rule == "segments" else RULES[rule]
    res = solve_batched(As, bs, cs, options=SimplexOptions(**opts), device="cpu")
    jres = jax_solve_batched(As, bs, cs, options=JaxOptions(**opts))
    np.testing.assert_array_equal(res.status, jres.status)
    assert res.status[2] == SolveStatus.UNBOUNDED
    As, bs, cs = _instances(8)
    res = solve_batched(As, bs, cs, options=SimplexOptions(max_iter=4, **opts), device="cpu")
    jres = jax_solve_batched(As, bs, cs, options=JaxOptions(max_iter=4, **opts))
    np.testing.assert_array_equal(res.status, jres.status)
    np.testing.assert_array_equal(res.iters, jres.iters)
    assert (res.status == SolveStatus.MAX_ITER).any()


def test_refactor_and_verify_rounds_under_rules():
    """refactor_every re-derives e (devex: gamma back to 1) for the due
    instances only; the answers stay JAX's."""
    As, bs, cs = stack_lps(4, 16, 40)
    for rule in ("devex", "steepest"):
        opts = dict(pricing=rule, refactor_every=3, recompute_every=2)
        res = solve_batched(As, bs, cs, options=SimplexOptions(**opts), device="cpu")
        jres = jax_solve_batched(As, bs, cs, options=JaxOptions(**opts))
        np.testing.assert_array_equal(res.status, jres.status)
        for i in range(4):
            assert relative_gap(float(res.z[i]), float(jres.z[i])) < 1e-5, (rule, i)


# --------------------------------------------------------------------------
# warm re-solves under every rule
# --------------------------------------------------------------------------

OPTS_WARM = dict(refactor_every=64)


@pytest.mark.parametrize("storage", ["dense", "scipy"])
@pytest.mark.parametrize("rule", ["devex", "steepest", "segments", "segments bf16"])
def test_reoptimize_batched_rules_match_jax(rule, storage):
    A, b, c = random_dense_lp(16, 40, seed=31)
    cold = solve(A, b, c, options=SimplexOptions(**OPTS_WARM), device="cpu")
    jcold = jax_solve(A, b, c, options=JaxOptions(**OPTS_WARM))
    rng = np.random.default_rng(9)
    bs2 = np.stack(
        [np.asarray(b, np.float64) * (1 + 0.3 * rng.uniform(-1, 1, b.shape)) for _ in range(8)]
    ).astype(np.float32)
    opts = dict(OPTS_WARM, **RULES[rule])
    if rule.startswith("segments"):
        opts["partial_min_segment"] = 8
    A_in = A if storage == "dense" else sps.csc_matrix(A)
    res = reoptimize_batched(A_in, bs2, c, cold, options=SimplexOptions(**opts), device="cpu")
    jres = jax_reoptimize_batched(A, bs2, c, jcold, options=JaxOptions(**opts))
    np.testing.assert_array_equal(res.status, jres.status)
    for i in range(8):
        if SolveStatus(int(res.status[i])) == SolveStatus.OPTIMAL:
            assert relative_gap(float(res.z[i]), float(jres.z[i])) < 1e-4, i
            assert relative_gap(float(res.z[i]), solve_scipy(A, bs2[i], c).z) < 1e-4, i
            assert float(res.feas_err[i]) < 1e-4


@pytest.mark.parametrize("rule", ["devex", "steepest"])
def test_warm_primal_cleanup_pivots_under_rules(rule):
    """A prior basis that is dual feasible but not optimal for the new c's
    rounding: the clean-up runs primal pivots under the rule (an entry
    basis from a coarse tolerance), answers JAX's."""
    As, bs, cs, u = bounded_stack(B=1, m=6, k=14, seed=5)
    A, b, c = As[0], bs[0], cs[0]
    cold = solve(A, b, c, u=u, device="cpu")
    jcold = jax_solve(A, b, c, u=u)
    rng = np.random.default_rng(3)
    bs2 = (b[None, :] * (1 + 0.3 * rng.uniform(-1, 1, (6, b.shape[0])))).astype(np.float32)
    opts = dict(pricing=rule)
    res = reoptimize_batched(A, bs2, c, cold, u=u, options=SimplexOptions(**opts), device="cpu")
    jres = jax_reoptimize_batched(A, bs2, c, jcold, u=u, options=JaxOptions(**opts))
    np.testing.assert_array_equal(res.status, jres.status)
    for i in range(6):
        single = solve(A, bs2[i], c, u=u, device="cpu")
        assert SolveStatus(int(res.status[i])) == single.status
        if single.status == SolveStatus.OPTIMAL:
            assert abs(float(res.z[i]) - single.z) < 1e-4 * (1 + abs(single.z))
            assert abs(float(res.z[i]) - float(jres.z[i])) < 1e-4 * (1 + abs(single.z))


def test_phase_switch_weights_are_exact():
    """At the warm re-solve's switch to the primal loop: e re-derived from
    the new inverse, devex weights 1, steepest-edge weights the exact norms
    1 + |B_inv A_j|^2 (float64, rtol 1e-8), in chunks of scenarios as
    small as one (the budget) and on a sparse A."""
    A, b, c = random_dense_lp(10, 26, seed=4, dtype=np.float64)
    cold = solve(A, b, c, options=SimplexOptions(dtype=torch.float64, backend="torch"), device="cpu")
    rng = np.random.default_rng(5)
    bs2 = b[None, :] * (1 + 0.2 * rng.uniform(-1, 1, (5, b.shape[0])))
    for storage in ("dense", "sparse"):
        A_t = torch.as_tensor(A) if storage == "dense" else from_scipy(sps.csc_matrix(A), torch.float64, "cpu")
        prob = Problem(A=A_t, b=torch.as_tensor(bs2), c=torch.as_tensor(c))
        s = bstep.batch_state_from_basis(prob, cold.basis, torch.float64, pricing="steepest")
        s.B_inv += 1e-3  # a drifted inverse for the re-inversion to repair
        mask = torch.tensor([True, False, True, True, False])
        s1 = bstep.refactorize(prob, s, mask, "steepest", exact_gamma=True)
        T = np.linalg.solve(A[:, cold.basis], A)
        want = 1 + (T * T).sum(0)
        for i in range(5):
            if mask[i]:
                np.testing.assert_allclose(s1.gamma[i].numpy(), want, rtol=1e-8)
                e_ref = s1.y[i].numpy() @ A - c
                np.testing.assert_allclose(s1.e[i].numpy(), e_ref, rtol=1e-8, atol=1e-10)
            else:
                assert torch.equal(s1.gamma[i], s.gamma[i]) and torch.equal(s1.e[i], s.e[i])
        X = s1.B_inv[mask]
        whole = bstep.steepest_gamma_batched(A_t, X, torch.float64)
        one = bstep.steepest_gamma_batched(A_t, X, torch.float64, budget=1)
        assert torch.equal(whole, one)
        s2 = bstep.refactorize(prob, s, mask, "devex")
        assert torch.equal(s2.gamma[mask], torch.ones(3, 26, dtype=torch.float64))


# --------------------------------------------------------------------------
# the batched state against JAX's, leaf by leaf
# --------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["devex", "steepest", "steepest defer", "devex bounded",
                                  "steepest bounded", "segments", "segments bf16"])
@pytest.mark.parametrize("k", [0, 3])
def test_batched_step_matches_jax(kind, k):
    """(The hopper backend: its wrappers run their plain twins here; the
    torch backend's steps are the solves' above.)"""
    backend = "hopper"
    u = None
    if "bounded" in kind:
        As, bs, cs, u = bounded_stack()
    else:
        As, bs, cs = stack_lps(5, 12, 32)
    rule = kind.split()[0]
    defer = 4 if "defer" in kind else 0
    pricing = rule if rule in ("devex", "steepest") else "dantzig"
    extra = dict(SEG, pricing_dtype="bfloat16" if "bf16" in kind else "float32") if rule == "segments" else {}
    jopts = JaxOptions(pricing=pricing, update_defer=defer, **extra)
    opts = SimplexOptions(backend=backend, pricing=pricing, update_defer=defer, **extra)
    js, jstep_fn, jargs = jax_batch_walk(As, bs, cs, jopts, k, u)
    leaves = carried(js, defer, u is not None)
    if pricing != "dantzig":
        leaves.update(e=np.asarray(js.e), gamma=np.asarray(js.gamma))
    s = bstep.batch_state_from_numpy(leaves, "cpu")
    prob = Problem(
        A=torch.as_tensor(As), b=torch.as_tensor(bs), c=torch.as_tensor(cs),
        u=None if u is None else torch.as_tensor(u),
    )
    if "bf16" in kind:
        prob.A_price = prob.A.to(torch.bfloat16)
    ctl = bstep.batch_control(s, opts, 10_000, prob=prob)
    s1 = bstep.batch_pivot_step(prob, s, opts, dispatch.get_backend(backend), ctl)
    js1 = jstep_fn(*jargs, js)
    np.testing.assert_array_equal(s1.basis.numpy(), np.asarray(js1.basis))
    for f in ("status", "iters", "degen"):
        np.testing.assert_array_equal(getattr(s1, f).numpy(), np.asarray(getattr(js1, f)), err_msg=f)
    floats = ["B_inv", "x_b", "y", "c_b"] + (["U", "R"] if defer else [])
    if pricing != "dantzig":
        floats += ["e", "gamma"]
    for f in floats:
        np.testing.assert_allclose(getattr(s1, f).numpy(), np.asarray(getattr(js1, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
    if u is not None:
        np.testing.assert_array_equal(s1.at_upper.numpy(), np.asarray(js1.at_upper))


@pytest.mark.parametrize("rule", ["devex", "steepest"])
def test_weighted_step_needs_the_pick(rule):
    As, bs, cs = stack_lps(2, 6, 14)
    prob = Problem(A=torch.as_tensor(As), b=torch.as_tensor(bs), c=torch.as_tensor(cs))
    s = bstep.batch_state_slack(prob, torch.float32, pricing=rule)
    opts = SimplexOptions(pricing=rule)
    with pytest.raises(ValueError, match="no pick"):
        bstep.batch_pivot_step(prob, s, opts, dispatch.get_backend("torch"), bstep.batch_control(s, opts, 100))


@pytest.mark.parametrize("defer", [0, 4])
def test_batched_weights_are_exact_norms_every_pivot(defer):
    """gamma[i]_j == 1 + |B_inv[i] A[i]_j|^2 on every nonbasic column and
    e[i] == y[i].A[i] - c[i] after every batch step (float64; rtol 1e-8
    and 1e-7), and each instance's e and gamma equal to the port's single
    solve after the same pivots (rtol 1e-9)."""
    B, m, n = 3, 10, 26
    lps = [random_dense_lp(m, n, seed=5 + i, dtype=np.float64) for i in range(B)]
    As, bs, cs = (np.stack([lp[k] for lp in lps]) for k in range(3))
    prob = Problem(A=torch.as_tensor(As), b=torch.as_tensor(bs), c=torch.as_tensor(cs))
    opts = SimplexOptions(pricing="steepest", dtype=torch.float64, update_defer=defer, backend="torch")
    be = dispatch.get_backend("torch")
    s = bstep.batch_state_slack(prob, torch.float64, defer, "steepest")
    singles = []
    for i in range(B):
        tp = problem_from_numpy(As[i], bs[i], cs[i], "cpu", torch.float64)
        singles.append((tp, initial_state_slack(tp, torch.float64, update_defer=defer, pricing="steepest")))
    for _ in range(8):
        ctl = bstep.batch_control(s, opts, 10_000, prob=prob)
        if not ctl.running:
            break
        s = bstep.batch_pivot_step(prob, s, opts, be, ctl)
        for i, (tp, ts) in enumerate(singles):
            if int(ts.status) == SolveStatus.RUNNING:
                ts = sstep.pivot_step(tp, ts, opts, be)
                singles[i] = (tp, ts)
            basis = s.basis[i].numpy()
            np.testing.assert_array_equal(basis, ts.basis.numpy())
            Bm = As[i][:, basis]
            T = np.linalg.solve(Bm, As[i])
            nonbasic = np.ones(n, bool)
            nonbasic[basis] = False
            np.testing.assert_allclose(s.gamma[i].numpy()[nonbasic], (1 + (T * T).sum(0))[nonbasic], rtol=1e-8)
            y = np.linalg.solve(Bm.T, cs[i][basis])
            np.testing.assert_allclose(s.e[i].numpy(), y @ As[i] - cs[i], rtol=1e-7, atol=1e-9)
            np.testing.assert_allclose(s.gamma[i].numpy(), ts.gamma.numpy(), rtol=1e-9)
            np.testing.assert_allclose(s.e[i].numpy(), ts.e.numpy(), rtol=1e-9, atol=1e-12)
    assert int(s.iters.min()) >= 3


def test_stale_flag_rides_in_the_control_read():
    """Under devex the batch takes no branch read: the stale mask is read
    with the control scalars, one read a batch step; an exact pass runs
    on exactly the steps whose control read said some active pick was
    stale."""
    As, bs, cs = _instances(8)
    passes = []
    plain = ops.choose_entering_batched

    def counting(*args, **kw):
        passes.append(bstep.steps["primal"])
        return plain(*args, **kw)

    bstep.reset_host_reads()
    mp = pytest.MonkeyPatch()
    mp.setattr(ops, "choose_entering_batched", counting)
    try:
        solve_batched(As, bs, cs, options=SimplexOptions(pricing="devex", verify_terminal=False, backend="torch"),
                      device="cpu")
    finally:
        mp.undo()
    assert bstep.host_reads["branch"] == 0
    assert bstep.host_reads["control"] == bstep.steps["primal"] + 1
    assert len(passes) == bstep.branches["stale"] > 0
    assert bstep.branches["segment"] == bstep.branches["shadow"] == 0


def test_segment_fallbacks_are_counted():
    """Segmented pricing: one branch read a batch step for the segment
    winners' recheck, one more on a step whose segment failed some active
    instance (then the full shadow), one more where that failed too."""
    As, bs, cs = _instances(8)
    bstep.reset_host_reads()
    solve_batched(As, bs, cs, options=SimplexOptions(pricing_dtype="bfloat16", verify_terminal=False, **SEG),
                  device="cpu")
    steps = bstep.steps["primal"]
    assert bstep.branches["segment"] > 0
    assert bstep.host_reads["branch"] == steps + bstep.branches["segment"]
    assert bstep.branches["stale"] == 0


# --------------------------------------------------------------------------
# the windowed pricing twin and the options
# --------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["stack", "shared"])
@pytest.mark.parametrize("signed", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_windowed_choose_is_the_single_op_on_the_slice(layout, signed, dtype):
    """``choose_entering_batched(..., window=(w, S, seg))``: instance i is
    the single op on columns [lo_i, lo_i + w), lo_i = (seg_i mod S) w, with
    its basis masked inside the window and the pick global; per-instance A
    bit for bit, a shared A to rounding (its slices go through one
    batched product, rtol 1e-6). Bland's rule with no eligible column
    picks lo_i. The hopper wrapper on CPU tensors is the twin."""
    g = torch.Generator().manual_seed(3)
    B, m, n, S = 7, 9, 60, 4
    w = n // S
    shared = layout == "shared"
    y = torch.randn(B, m, generator=g)
    c = torch.randn(n, generator=g) if shared else torch.randn(B, n, generator=g)
    A = torch.randn(*(() if shared else (B,)), m, n, generator=g).to(dtype)
    basis = torch.stack([torch.randperm(n, generator=g)[:m] for _ in range(B)]).to(torch.int32)
    bland = torch.arange(B) % 2 == 1
    up = torch.rand(B, n, generator=g) < 0.3 if signed else None
    seg = torch.tensor([0, 3, 5, 2, 11, 1, 7], dtype=torch.int32)
    win = (w, S, seg)
    p, min_e = ops.choose_entering_batched(y, A, c, 1e-5, bland, basis, up, win)
    p_h, min_h = hopper.choose_entering_batched(y, A, c, 1e-5, bland, basis, up, win)
    assert torch.equal(p, p_h) and torch.equal(min_e, min_h)
    for i in range(B):
        lo = int(seg[i]) % S * w
        A_i, c_i = (A, c) if shared else (A[i], c[i])
        A_w, c_w = A_i[:, lo : lo + w], c_i[lo : lo + w]
        if signed:
            p1, m1 = ops.choose_entering_bounded(y[i], A_w, c_w, up[i, lo : lo + w], basis[i], lo, 1e-5, bland[i])
        else:
            p1, m1 = ops.choose_entering(y[i], A_w, c_w, 1e-5, bland[i], basis[i], lo)
        assert lo <= int(p[i]) < lo + w
        if bool(bland[i]) and float(m1) >= -1e-5:
            assert int(p[i]) == lo  # no eligible column: the window's start
        else:
            assert int(p[i]) == int(p1), i
        torch.testing.assert_close(min_e[i], m1, rtol=1e-6, atol=1e-6)
    # all Bland, nothing eligible: every pick is its window's start
    p0, _ = ops.choose_entering_batched(
        y * 0, A, torch.full_like(c, -1e3), 1e-5, torch.ones(B, dtype=torch.bool), basis, None, win
    )
    assert torch.equal(p0.long(), torch.remainder(seg.long(), S) * w)


def test_window_plan_and_checks():
    plan = hopper.batch_pricing_plan
    # the segmented cell, 64 x 512 x 4096 with w = 512: the bulk-copy scan,
    # two chunks of 256 columns merged in their cluster, one launch; its
    # bf16 shadow the same; beyond 8 chunks a reduction launch
    p = plan(64, 512, 4096, shared=False, bf16=False, align=16, window=512, segments=8)
    assert {k: p[k] for k in ("layout", "grid", "threads", "chunks", "reduce", "words",
                              "group_tiles", "launches", "scratch_words")} == dict(
        layout="window_tma", grid=(2, 64), threads=288, chunks=2, reduce=False, words=0,
        group_tiles=0, launches=1, scratch_words=0)
    p = plan(64, 512, 4096, shared=False, bf16=True, align=16, window=512, segments=8)
    assert (p["layout"], p["grid"], p["threads"], p["launches"]) == ("window_tma", (2, 64), 96, 1)
    p = plan(64, 512, 4096, shared=False, bf16=True, align=16, window=256, segments=16)
    assert (p["chunks"], p["launches"], p["scratch_words"]) == (1, 1, 0)
    p = plan(64, 512, 4096, shared=False, bf16=False, align=16, window=2304, segments=1)
    assert (p["chunks"], p["reduce"], p["launches"], p["scratch_words"]) == (9, True, 2, 64 * 9 * 3)
    # what bulk copies cannot take forces the scan: m % 4, the alignment, a
    # row or a window that is not a multiple of 16 bytes
    for m, n, w, align, bf16, want in (
        (511, 4096, 512, 16, False, "scan"), (512, 4096, 512, 8, False, "scan"),
        (512, 4098, 512, 16, False, "scan"), (512, 4096, 510, 16, False, "scan"),
        (512, 4096, 508, 16, True, "bf16x4"), (512, 4100, 512, 16, True, "bf16x4"),
        (512, 4096, 512, 16, True, "window_tma"), (512, 4096, 8, 16, True, "window_tma"),
    ):
        p = plan(64, m, n, shared=False, bf16=bf16, align=align, window=w, segments=2)
        assert p["layout"] == want, (m, n, w, align, bf16)
        assert p["grid"] == (-(-w // 256), 64) and p["words"] == p["group_tiles"] == 0
    p = plan(64, 512, 4098, shared=False, bf16=True, align=16, window=2049, segments=2)
    assert p["layout"] == "scan" and p["chunks"] == 9
    # a shared A: the grouping (with the mask), the tiled product over each
    # window's 32-column tiles, ceil(B / 16) + S - 1 instance tiles, and a
    # reduction beyond one tile
    p = plan(256, 2048, 4096, shared=True, bf16=False, align=16, window=512, segments=8)
    assert {k: p[k] for k in ("layout", "grid", "threads", "chunks", "words", "group_tiles",
                              "launches", "scratch_words")} == dict(
        layout="window_group", grid=(16, 23), threads=64, chunks=16, words=128, group_tiles=23,
        launches=3, scratch_words=256 * 128 + (256 + 9 + 3 * 23) + 256 * 16 * 3)
    # S = 1 (one window, the whole row), and B not a multiple of 16
    p = plan(256, 2048, 4096, shared=True, bf16=True, align=16, window=4096, segments=1)
    assert (p["layout"], p["grid"], p["group_tiles"]) == ("window_group", (128, 16), 16)
    p = plan(70, 32, 300, shared=True, bf16=False, align=16, window=100, segments=3)
    assert (p["layout"], p["grid"], p["chunks"], p["launches"]) == ("window_group", (4, 7), 4, 3)
    # element loads where m, n, w or the alignment forbid 16-byte copies
    for m, n, w, align in ((33, 300, 100, 16), (32, 301, 100, 16), (32, 300, 98, 16), (32, 300, 100, 8)):
        p = plan(70, m, n, shared=True, bf16=False, align=align, window=w, segments=3)
        assert p["layout"] == "window_group_loads", (m, n, w, align)
    # one tile: the product writes the choice; beyond 1024 windows the scan at stride 0
    p = plan(9, 16, 1040, shared=True, bf16=False, align=16, window=32, segments=2)
    assert (p["chunks"], p["launches"], p["scratch_words"]) == (1, 2, 9 * 33 + 9 + 3 + 3 * 2)
    p = plan(4, 8, 2050, shared=True, bf16=False, align=16, window=2, segments=1025)
    assert (p["layout"], p["words"], p["group_tiles"], p["launches"]) == ("scan", 0, 0, 1)
    with pytest.raises(ValueError, match="grid"):
        plan(65535 * 16, 4, 16, shared=True, bf16=False, align=16, window=8, segments=2)
    with pytest.raises(ValueError, match="segments"):
        plan(64, 512, 4096, shared=False, bf16=False, align=16, window=512)
    y, A, c = torch.zeros(2, 3), torch.zeros(2, 3, 8), torch.zeros(2, 8)
    basis, no = torch.zeros(2, 3, dtype=torch.int32), torch.zeros(2, dtype=torch.bool)
    with pytest.raises(ValueError, match="exceed"):
        hopper.choose_entering_batched(y, A, c, 1e-5, no, basis, None, (3, 3, torch.zeros(2, dtype=torch.int32)))
    with pytest.raises(ValueError, match="window seg"):
        hopper.choose_entering_batched(y, A, c, 1e-5, no, basis, None, (4, 2, torch.zeros(3, dtype=torch.int32)))


@pytest.mark.parametrize(
    "B, S, spread",
    [(256, 8, "random"), (70, 3, "random"), (37, 5, "one window"), (33, 1, "random"),
     (50, 7, "negative"), (1, 4, "random"), (300, 1024, "random")],
)
def test_window_groups(B, S, spread):
    """The grouped window's first step (``ops.window_groups``, and the hopper
    wrapper on CPU tensors) against numpy's stable argsort of seg mod S:
    every instance once, grouped by window, ascending inside a window,
    offsets the windows' counts summed, B at the end."""
    rng = np.random.default_rng(B + S)
    seg = rng.integers(0, 1000, B)
    if spread == "one window":
        seg = np.full(B, 3 * S + 2)
    elif spread == "negative":
        seg = seg - 600
    seg_t = torch.as_tensor(seg, dtype=torch.int32)
    for perm, offsets in (ops.window_groups(seg_t, S), hopper.window_groups(seg_t, S)):
        s = np.mod(seg, S)
        assert perm.dtype == offsets.dtype == torch.int32
        np.testing.assert_array_equal(perm.numpy(), np.argsort(s, kind="stable"))
        want = np.concatenate([[0], np.cumsum(np.bincount(s, minlength=S))])
        np.testing.assert_array_equal(offsets.numpy(), want)
        assert offsets[-1] == B
        for w in range(S):
            part = perm[offsets[w]:offsets[w + 1]].numpy()
            assert (np.mod(seg[part], S) == w).all() and (np.diff(part) > 0).all()
    with pytest.raises(ValueError, match="window_groups"):
        hopper.window_groups(seg_t, 1025)


@pytest.mark.parametrize("layout", ["stack", "shared", "stack float64", "shared float64"])
@pytest.mark.parametrize("bland", [False, True])
def test_windowed_choose_matches_jax_segments(layout, bland):
    """The windowed twin against the JAX package's segment switch
    (``simplex_tpu/core/step.py:616-640``): ``jax.vmap`` of
    ``kernels.xla.choose_entering`` over each instance's static slice,
    chosen by ``lax.switch`` on iters mod S, with c masked by
    ``xla.mask_basic``; seeded numpy fp32 inputs (float64 in the float64
    layouts: y, A and c in double in both packages). Picks equal (no ties),
    min_e within rtol / atol 1e-5 (fp32 sums in another order; 1e-12 in
    float64)."""
    import jax
    import jax.numpy as jnp

    from simplex_tpu.kernels import xla

    rng = np.random.default_rng(17)
    B, m, n, S = 6, 7, 48, 4
    w = n // S
    shared = layout.startswith("shared")
    dt, tol = (np.float64, 1e-12) if layout.endswith("float64") else (np.float32, 1e-5)
    y = rng.standard_normal((B, m)).astype(dt)
    A = rng.standard_normal((m, n) if shared else (B, m, n)).astype(dt)
    c = rng.standard_normal((B, n)).astype(dt)
    basis = np.stack([rng.permutation(n)[:m] for _ in range(B)]).astype(np.int32)
    iters = rng.integers(-50, 100, B).astype(np.int32)
    flags = np.full(B, bland)

    def one(y, A, c, basis, it, flag):
        c_eff = xla.mask_basic(c, basis)

        def segment(s):
            def br(_):
                p, mn = xla.choose_entering(
                    y, jax.lax.slice_in_dim(A, s * w, (s + 1) * w, axis=1),
                    jax.lax.slice_in_dim(c_eff, s * w, (s + 1) * w), 1e-5, flag)
                return (s * w + p).astype(jnp.int32), mn

            return br

        return jax.lax.switch(it % S, [segment(s) for s in range(S)], None)

    p_j, min_j = jax.vmap(one, in_axes=(0, None if shared else 0, 0, 0, 0, 0))(
        y, A, c, basis, iters, flags)
    p, min_e = ops.choose_entering_batched(
        torch.as_tensor(y), torch.as_tensor(A), torch.as_tensor(c), 1e-5, torch.as_tensor(flags),
        torch.as_tensor(basis), None, (w, S, torch.as_tensor(iters)))
    assert min_e.dtype == torch.from_numpy(y).dtype and np.asarray(min_j).dtype == dt
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_j))
    np.testing.assert_allclose(min_e.numpy(), np.asarray(min_j), rtol=tol, atol=tol)


def test_segments_follow_the_static_test():
    """Segments price only where S | n and n / S >= partial_min_segment,
    on a dense A (``simplex_tpu.core.step._partial_active``)."""
    As, bs, cs = stack_lps(2, 6, 32)
    prob = Problem(A=torch.as_tensor(As), b=torch.as_tensor(bs), c=torch.as_tensor(cs))
    assert bstep.segments(SimplexOptions(partial_pricing=4, partial_min_segment=8), prob) == (8, 4)
    assert bstep.segments(SimplexOptions(partial_pricing=4, partial_min_segment=9), prob) is None
    assert bstep.segments(SimplexOptions(partial_pricing=5, partial_min_segment=1), prob) is None
    assert bstep.segments(SimplexOptions(), prob) is None
    shared = Problem(A=from_scipy(sps.csc_matrix(As[0]), torch.float32, "cpu"), b=prob.b, c=prob.c[0])
    assert bstep.segments(SimplexOptions(partial_pricing=4, partial_min_segment=1), shared) is None


def test_pricing_sparse_is_inert():
    """As in the JAX package, the batched paths build no sparse shadow:
    ``pricing_sparse`` logs that it is inert and changes nothing."""
    As, bs, cs = stack_lps(3, 8, 20)
    seen = []
    handler = logging.Handler()
    handler.emit = lambda record: seen.append(record.getMessage())
    log = get_logger("batch")
    log.addHandler(handler)
    try:
        res = solve_batched(As, bs, cs, options=SimplexOptions(pricing_sparse=True), device="cpu")
        A, b, c = random_dense_lp(8, 20, seed=1)
        cold = solve(A, b, c, device="cpu")
        warm = reoptimize_batched(A, bs, c, cold, options=SimplexOptions(pricing_sparse=True), device="cpu")
    finally:
        log.removeHandler(handler)
    assert any("pricing_sparse is inert in solve_batched" in msg for msg in seen)
    assert any("pricing_sparse is inert in reoptimize_batched" in msg for msg in seen)
    np.testing.assert_array_equal(res.basis, solve_batched(As, bs, cs, device="cpu").basis)
    np.testing.assert_array_equal(warm.basis, reoptimize_batched(A, bs, c, cold, device="cpu").basis)


def test_weighted_rules_build_no_shadow():
    """Devex and steepest edge never read a pricing shadow (JAX's
    ``with_pricing_shadow``): bf16 pricing_dtype changes nothing there."""
    As, bs, cs = _instances(4)
    for rule in ("devex", "steepest"):
        a = solve_batched(As, bs, cs, options=SimplexOptions(pricing=rule), device="cpu")
        b = solve_batched(As, bs, cs, options=SimplexOptions(pricing=rule, pricing_dtype="bfloat16"), device="cpu")
        np.testing.assert_array_equal(a.basis, b.basis)
        np.testing.assert_array_equal(a.iters, b.iters)
