"""The bench-sparse class's fp32 drift: the reference does the same.

``bench.py --mode sparse``'s recipe (``tests/bench_sparse_drift.py``) can
end OPTIMAL with a basis that is primal infeasible in float64, in both
packages, with the split between them decided by rounding. The smallest
instance found where the two packages' answers split by more than 1e-3 in
float64 feas_err is 2048 x 4096, seed 2, steepest edge with
``refactor_every=512`` (port 0.0205, JAX 0.0; ``python -m
tests.bench_sparse_drift 2048 4096 --refactor-every 512 --seed 2``). There,
from one state (the port's after 512 pivots, carried into the JAX
package): both packages take the same next pivot, and the re-inversion at
that pivot leaves x_b off the float64 basic solution by more than 1e-3 in
BOTH packages (the basis has a condition number near 6e4, so an fp32
inverse keeps about 1e-2 of x_b), by errors of one size in the two
packages (0.015 and 0.010 here). The paths then part on rounding: a
property of fp32 on this class, not a port fault.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.core import step as jstep
from simplex_tpu.core.state import Problem as JaxProblem
from simplex_tpu.core.state import initial_state as jax_initial
from simplex_tpu.kernels.dispatch import get_backend as jax_backend
from simplex_tpu_torch import SimplexOptions
from simplex_tpu_torch.core import step
from simplex_tpu_torch.core.solver import solve_state
from simplex_tpu_torch.core.state import initial_state_slack, problem_from_numpy
from simplex_tpu_torch.kernels import dispatch
from tests.bench_sparse_drift import bench_sparse_lp

M, N, SEED, PIVOTS = 2048, 4096, 2, 512


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the cores,
    and a torch parallel region (a sparse product enters one on every
    call) waits for threads that are not scheduled."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_refactor_on_the_bench_sparse_class_drifts_in_the_reference_too():
    A, b, c = bench_sparse_lp(M, N, SEED)
    tp = problem_from_numpy(A, b, c, "cpu")
    backend = dispatch.get_backend("torch")
    walk = SimplexOptions(pricing="steepest", backend="torch", verify_terminal=False, perturb_after=0)
    s = solve_state(tp, initial_state_slack(tp, torch.float32, pricing="steepest"), walk, PIVOTS, backend)
    assert int(s.iters) == PIVOTS
    s.status = torch.zeros_like(s.status)

    jp = JaxProblem(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    js = jax_initial(jp, jnp.asarray(s.basis.numpy()), jnp.float32, "steepest", 0, None, 0)
    js = js._replace(
        B_inv=jnp.asarray(s.B_inv.numpy()), x_b=jnp.asarray(s.x_b.numpy()),
        y=jnp.asarray(s.y.numpy()), e=jnp.asarray(s.e.numpy()), gamma=jnp.asarray(s.gamma.numpy()),
        iters=jnp.int32(PIVOTS), degen=jnp.int32(int(s.degen)), last_refac=jnp.int32(0),
    )
    jb = jax_backend("xla")

    # the same next pivot from the same state
    opts = SimplexOptions(pricing="steepest", backend="torch")
    s1 = step.pivot_step(tp, s, opts, backend)
    js1 = jstep.pivot_step(jp, js, JaxOptions(pricing="steepest"), jb)
    np.testing.assert_array_equal(s1.basis.numpy(), np.asarray(js1.basis))

    # the re-inversion of that basis loses ~1e-2 of x_b in both packages
    basis = s.basis.numpy()
    x64 = np.linalg.solve(A[:, basis].astype(np.float64), b.astype(np.float64))
    port_err = np.abs(step.refactorize(tp, s, backend, False, "steepest").x_b.numpy() - x64).max()
    jax_err = np.abs(np.asarray(jstep.refactorize(jp, js, jb, "steepest", False).x_b) - x64).max()
    assert jax_err > 1e-3 and port_err > 1e-3, (port_err, jax_err)
    assert max(port_err, jax_err) < 4 * min(port_err, jax_err), (port_err, jax_err)
