"""The port's pivot step, refactorization and inversion against the JAX
package's, from the same state.

States carry across with ``state_from_numpy``: the JAX solver state's
leaves go to host arrays and come back as the port's tensors, so one step
of each package starts from identical numbers, including a drifted
mid-solve state. Inputs are numpy-seeded and float32 in both packages.

Tolerances: the basis, q and status must match exactly; B_inv, x_b and y
to rtol 1e-5 / atol 1e-5 after one step (fp32 matvecs that sum in another
order), to rtol 1e-4 along the 63-pivot Klee-Minty path, where values reach
5^6 and errors accumulate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.core import linalg as jlinalg
from simplex_tpu.core import step as jstep
from simplex_tpu.core.state import Problem as JaxProblem
from simplex_tpu.core.state import initial_state_slack as jax_slack
from simplex_tpu.kernels.dispatch import get_backend as jax_backend
from simplex_tpu.oracle.generator import klee_minty_lp, random_dense_lp
from simplex_tpu_torch.config import SimplexOptions
from simplex_tpu_torch.core import linalg, step
from simplex_tpu_torch.core.step import read_control
from simplex_tpu_torch.core.state import (
    initial_state_slack,
    problem_from_numpy,
    state_from_numpy,
)
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.status import SolveStatus

JB = jax_backend("xla")


def leaves(s):
    """A JAX SolverState's leaves as host arrays."""
    d = {
        f: np.asarray(getattr(s, f))
        for f in ("B_inv", "x_b", "y", "c_b", "basis", "iters", "status", "degen", "last_refac")
    }
    d["pert"] = None if s.pert is None else tuple(np.asarray(v) for v in s.pert)
    return d


def problems(A, b, c):
    A, b, c = (np.asarray(v, np.float32) for v in (A, b, c))
    jp = JaxProblem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    return jp, problem_from_numpy(A, b, c, "cpu")


def jax_step_fn(opts):
    return jax.jit(lambda p, s: jstep.pivot_step(p, s, opts, JB))


def assert_same(ts, js, rtol=1e-5, atol=1e-5):
    np.testing.assert_array_equal(ts.basis.numpy(), np.asarray(js.basis))
    for f in ("status", "iters", "degen"):
        assert int(getattr(ts, f)) == int(getattr(js, f)), f
    for f in ("B_inv", "x_b", "y", "c_b"):
        np.testing.assert_allclose(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)), rtol=rtol, atol=atol, err_msg=f
        )


def jax_walk(jp, k, perturb=True):
    js = jax_slack(jp, jnp.float32, perturb=perturb)
    fn = jax_step_fn(JaxOptions())
    for _ in range(k):
        js = fn(jp, js)
    return js


@pytest.mark.parametrize("backend", ["torch", "hopper"])
@pytest.mark.parametrize("m,n,seed,k", [(16, 40, 1, 0), (16, 40, 1, 5), (32, 100, 2, 8)])
def test_pivot_step_matches_jax_from_same_state(backend, m, n, seed, k):
    jp, tp = problems(*random_dense_lp(m, n, seed=seed))
    js = jax_walk(jp, k)
    ts = state_from_numpy(leaves(js), "cpu")
    js1 = jax_step_fn(JaxOptions())(jp, js)
    ts1 = step.pivot_step(tp, ts, SimplexOptions(backend=backend), get_backend(backend))
    assert_same(ts1, js1)


@pytest.mark.parametrize("ratio", ["harris", "classic"])
def test_pivot_step_matches_jax_from_drifted_state(ratio):
    # a mid-solve state whose inverse has drifted off the true one by ~1e-4
    jp, tp = problems(*random_dense_lp(24, 60, seed=3))
    js = jax_walk(jp, 8)
    noise = np.random.default_rng(0).standard_normal(js.B_inv.shape) * 1e-4
    js = js._replace(B_inv=js.B_inv + jnp.asarray(noise, jnp.float32))
    ts = state_from_numpy(leaves(js), "cpu")
    js1 = jax_step_fn(JaxOptions(ratio=ratio))(jp, js)
    ts1 = step.pivot_step(tp, ts, SimplexOptions(ratio=ratio), get_backend("hopper"))
    assert_same(ts1, js1)


def test_terminal_step_changes_nothing():
    jp, tp = problems(*random_dense_lp(6, 15, seed=4))
    opts = SimplexOptions()
    ts = initial_state_slack(tp, torch.float32)
    for _ in range(200):
        ts = step.pivot_step(tp, ts, opts, get_backend("hopper"))
        if int(ts.status) != SolveStatus.RUNNING:
            break
    assert int(ts.status) == SolveStatus.OPTIMAL
    before = {f: getattr(ts, f).clone() for f in ("B_inv", "x_b", "y", "basis", "iters")}
    again = step.pivot_step(tp, ts, opts, get_backend("hopper"))
    for f, v in before.items():
        assert torch.equal(getattr(again, f), v), f
    assert int(again.status) == SolveStatus.OPTIMAL


def test_unbounded_step_matches_jax():
    A = np.array([[-1.0, 1.0, 1.0]])
    jp, tp = problems(A, [1.0], [1.0, 0.0, 0.0])
    js = jax_step_fn(JaxOptions())(jp, jax_slack(jp, jnp.float32))
    ts = step.pivot_step(tp, initial_state_slack(tp, torch.float32), SimplexOptions(),
                         get_backend("hopper"))
    assert int(ts.status) == int(js.status) == SolveStatus.UNBOUNDED
    assert_same(ts, js)


def test_klee_minty_pivot_path_matches_jax():
    # tie-free: Dantzig walks all 2^6 - 1 = 63 vertices to z = 5^6
    jp, tp = problems(*klee_minty_lp(6))
    js = jax_slack(jp, jnp.float32, perturb=True)
    ts = initial_state_slack(tp, torch.float32, perturb=True)
    fn = jax_step_fn(JaxOptions())
    opts, be = SimplexOptions(), get_backend("hopper")
    for _ in range(80):
        js = fn(jp, js)
        ts = step.pivot_step(tp, ts, opts, be)
        assert_same(ts, js, rtol=1e-4, atol=1e-3)
        if int(ts.status) != SolveStatus.RUNNING:
            break
    assert int(ts.status) == SolveStatus.OPTIMAL and int(ts.iters) == 63
    z = float(ts.c_b @ ts.x_b)
    assert abs(z - 15625.0) < 1e-3 * 15625.0
    assert read_control(ts).iters == 63


def test_refactorize_matches_jax():
    jp, tp = problems(*random_dense_lp(20, 50, seed=5))
    js = jax_walk(jp, 10)
    noise = np.random.default_rng(1).standard_normal(js.B_inv.shape) * 1e-3
    js = js._replace(B_inv=js.B_inv + jnp.asarray(noise, jnp.float32))
    ts = state_from_numpy(leaves(js), "cpu")
    jr = jstep.refactorize(jp, js, JB)
    tr = step.refactorize(tp, ts, get_backend("hopper"))
    B = np.asarray(jp.A)[:, np.asarray(js.basis)].astype(np.float64)
    np.testing.assert_allclose(tr.B_inv.double().numpy() @ B, np.eye(20), atol=1e-5)
    assert_same(tr, jr, rtol=1e-5, atol=1e-5)
    assert int(tr.last_refac) == int(jr.last_refac) == int(js.iters) > 0


@pytest.mark.parametrize("seeded", [False, True])
def test_inverse_newton_matches_jax(seeded):
    rng = np.random.default_rng(7)
    B = (rng.standard_normal((24, 24)) + 6 * np.eye(24)).astype(np.float32)
    seed = (np.linalg.inv(B) + 1e-3 * rng.standard_normal((24, 24))).astype(np.float32)
    Xj, rj = jlinalg.inverse_newton(
        jnp.asarray(B), seed=jnp.asarray(seed) if seeded else None
    )
    Xt, rt = linalg.inverse_newton(
        torch.from_numpy(B), seed=torch.from_numpy(seed) if seeded else None
    )
    assert rt < 1e-4 and float(rj) < 1e-4
    np.testing.assert_allclose(Xt.numpy(), np.asarray(Xj), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(Xt.double().numpy() @ B, np.eye(24), atol=1e-4)


def test_newton_bad_seed_restarts_from_scaling():
    B = torch.from_numpy((np.eye(8) * 3 + 0.1).astype(np.float32))
    X, r = linalg.inverse_newton(B, seed=torch.full((8, 8), float("nan")))
    assert r < 1e-5
    np.testing.assert_allclose((X @ B).numpy(), np.eye(8), atol=1e-5)


def test_perturb_activate_and_recompute_match_jax():
    jp, tp = problems(*random_dense_lp(12, 30, seed=5))
    js = jax_walk(jp, 4)
    ts = state_from_numpy(leaves(js), "cpu")
    scale = step.perturb_scale(SimplexOptions(), 2)
    assert scale == float(np.float32(1e-4) * 4)
    jp2 = jstep.perturb_activate(jp, js, JB, scale)
    tp2 = step.perturb_activate(tp, ts, get_backend("torch"), scale)
    np.testing.assert_allclose(tp2.x_b.numpy(), np.asarray(jp2.x_b), rtol=1e-6)
    np.testing.assert_allclose(tp2.pert.w.numpy(), np.asarray(jp2.pert.w), rtol=1e-5, atol=1e-7)
    assert bool(tp2.pert.on) and int(tp2.pert.rounds) == int(jp2.pert.rounds) == 1
    assert int(tp2.degen) == 0
    jr = jstep.recompute_xy(jp, jstep.perturb_clear(jp2), False)
    tr = step.recompute_xy(tp, step.perturb_clear(tp2))
    assert not bool(tr.pert.on) and float(tr.pert.w.abs().max()) == 0.0
    np.testing.assert_allclose(tr.x_b.numpy(), np.asarray(jr.x_b), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tr.y.numpy(), np.asarray(jr.y), rtol=1e-5, atol=1e-6)
