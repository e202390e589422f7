"""The port's pivot trace (``simplex_tpu_torch.core.trace``) against the JAX
package's ``simplex_tpu.core.trace`` on the same float32 inputs: the
sample's known path, a random instance's whole path, the dual trace, the
neutralized options, sparse A, and records that are copies. Mirrors
``tests/test_trace.py``.

Tolerances: entering / leaving columns, rows, statuses and bases exactly
(tie-free instances); objective, theta and min_reduced_cost to rel / abs
1e-5 (fp32 sums in another order).
"""

import io

import numpy as np
import pytest
import scipy.sparse as sps

from simplex_tpu import SimplexOptions as JaxOptions
from simplex_tpu import solve as jax_solve
from simplex_tpu.core.trace import trace_pivots as jax_trace
from simplex_tpu.oracle.generator import random_dense_lp
from simplex_tpu_torch import SimplexOptions, SolveStatus, solve
from simplex_tpu_torch.core.trace import print_trace, trace_pivots
from simplex_tpu_torch.kernels import hopper
from simplex_tpu_torch.io.text import load_lp

SAMPLE = "tests/data/sample.txt"


def f32(*vs):
    return tuple(np.asarray(v, np.float32) for v in vs)


def assert_same_records(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.iteration, g.entering, g.leaving_row, g.leaving) == (
            w.iteration, w.entering, w.leaving_row, w.leaving)
        assert int(g.status) == int(w.status)
        np.testing.assert_array_equal(g.basis, np.asarray(w.basis))
        assert g.objective == pytest.approx(w.objective, rel=1e-5, abs=1e-5)
        assert g.min_reduced_cost == pytest.approx(w.min_reduced_cost, rel=1e-5, abs=1e-5)
        if np.isfinite(w.theta):
            assert g.theta == pytest.approx(w.theta, rel=1e-5, abs=1e-5)
        else:
            assert np.isnan(g.theta)
        np.testing.assert_allclose(g.x_b, np.asarray(w.x_b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["hopper", "torch"])
def test_trace_golden_sample_pivot_path(backend):
    # the bundled 2x4 sample: the known 2-pivot path to the optimum 9
    A, b, c = f32(*load_lp(SAMPLE))
    recs = list(trace_pivots(A, b, c, options=SimplexOptions(backend=backend), device="cpu"))
    assert [r.entering for r in recs] == [0, 1, -1]
    assert [r.leaving for r in recs] == [3, 2, -1]
    assert recs[0].theta == 2.5 and recs[1].theta == 3.0
    assert recs[-1].objective == 9.0 and recs[-1].status == SolveStatus.OPTIMAL
    assert_same_records(recs, list(jax_trace(A, b, c)))


def test_trace_reaches_same_optimum_as_solve_and_jax():
    A, b, c = f32(*random_dense_lp(8, 20, seed=13))
    direct = solve(A, b, c, device="cpu")
    recs = list(trace_pivots(A, b, c, device="cpu"))
    assert recs[-1].status == SolveStatus.OPTIMAL
    assert abs(recs[-1].objective - direct.z) < 1e-5
    np.testing.assert_array_equal(recs[-1].basis, direct.basis)
    # one record a pivot plus the terminal one
    assert len(recs) == direct.iters + 1
    assert_same_records(recs, list(jax_trace(A, b, c)))


def test_print_trace_output_matches_jax():
    A, b, c = f32(*random_dense_lp(4, 10, seed=14))
    buf = io.StringIO()
    print_trace(A, b, c, file=buf, verbose=True, device="cpu")
    out = buf.getvalue()
    assert "# Iteration 1" in out and "entering x_" in out and "Optimum found." in out
    from simplex_tpu.core.trace import print_trace as jax_print

    jbuf = io.StringIO()
    jax_print(A, b, c, file=jbuf)
    buf = io.StringIO()
    print_trace(A, b, c, file=buf, device="cpu")
    assert buf.getvalue() == jbuf.getvalue()


def test_trace_dual_pivots_match_jax():
    A, b, c = f32(*random_dense_lp(12, 30, seed=15))
    cold = jax_solve(A, b, c, options=JaxOptions(refactor_every=64))
    rng = np.random.default_rng(7)
    b2 = (np.asarray(b, np.float64) * (1 + 0.3 * rng.uniform(-1, 1, b.shape))).astype(np.float32)
    recs = list(trace_pivots(A, b2, c, basis0=cold.basis, dual=True,
                             options=SimplexOptions(verify_terminal=False), device="cpu"))
    want = list(jax_trace(A, b2, c, basis0=cold.basis, dual=True,
                          options=JaxOptions(verify_terminal=False)))
    assert recs and recs[-1].status in (SolveStatus.OPTIMAL, SolveStatus.INFEASIBLE)
    if recs[-1].status == SolveStatus.OPTIMAL:
        assert recs[-1].x_b.min() > -1e-4
    for r in recs[:-1]:
        assert r.entering >= 0 and r.leaving >= 0
    assert_same_records(recs, want)


@pytest.mark.parametrize("extra", [dict(update_defer=8), dict(multi_price=4), dict(update_defer=4, multi_price=4)])
def test_trace_neutralizes_defer_and_multi_price(extra):
    # the trace reports the eager single-candidate walk of the same rule
    A, b, c = f32(*random_dense_lp(10, 26, seed=16))
    plain = list(trace_pivots(A, b, c, device="cpu"))
    recs = list(trace_pivots(A, b, c, options=SimplexOptions(**extra), device="cpu"))
    assert_same_records(recs, plain)


@pytest.mark.parametrize("pricing", ["devex", "steepest"])
def test_trace_weighted_pricing_matches_jax(pricing):
    A, b, c = f32(*random_dense_lp(10, 26, seed=17))
    recs = list(trace_pivots(A, b, c, options=SimplexOptions(pricing=pricing), device="cpu"))
    assert_same_records(recs, list(jax_trace(A, b, c, options=JaxOptions(pricing=pricing))))


def test_records_are_copies():
    # the step rewrites B_inv in place: a record's inverse and values must
    # stay those of its own pivot
    A, b, c = f32(*random_dense_lp(6, 15, seed=18))
    recs = list(trace_pivots(A, b, c, keep_inverse=True, device="cpu"))
    assert len(recs) >= 3
    for r in recs:
        B = A[:, r.basis].astype(np.float64)
        np.testing.assert_allclose(r.B_inv @ B, np.eye(6), atol=1e-4)
        np.testing.assert_allclose(B @ r.x_b, b, rtol=1e-4, atol=1e-4)
    assert not np.array_equal(recs[0].B_inv, recs[-1].B_inv)
    assert all(r.B_inv is None for r in trace_pivots(A, b, c, device="cpu"))


def test_trace_sparse_matches_dense():
    A, b, c = f32(*random_dense_lp(10, 26, seed=19))
    A[:, :16][np.random.default_rng(0).uniform(size=(10, 16)) > 0.5] = 0.0
    dense = list(trace_pivots(A, b, c, device="cpu"))
    recs = list(trace_pivots(sps.csc_matrix(A), b, c, device="cpu"))
    assert_same_records(recs, dense)
    assert_same_records(recs, list(jax_trace(sps.csc_matrix(A), b, c)))
    with pytest.raises(NotImplementedError, match="partial_pricing"):
        list(trace_pivots(sps.csc_matrix(A), b, c, device="cpu",
                          options=SimplexOptions(partial_pricing=2, partial_min_segment=1)))


def test_trace_min_reduced_cost_runs_the_pricing_call(monkeypatch):
    # one choose_entering call a pivot for min_reduced_cost, beside the
    # step's own (the hopper wrapper, plain on CPU tensors): each step
    # prices the next one, and the first prices itself too (core.step)
    A, b, c = f32(*load_lp(SAMPLE))
    calls = []
    real = hopper.choose_entering
    # get_backend reads the wrapper off the module at each call
    monkeypatch.setattr(hopper, "choose_entering", lambda *a, **k: calls.append(1) or real(*a, **k))
    recs = list(trace_pivots(A, b, c, device="cpu"))
    assert len(calls) == 2 * len(recs) + 1
