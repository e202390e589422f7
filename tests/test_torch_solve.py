"""The port's solve, end to end on the CPU, against ``simplex_tpu.solve``
and HiGHS.

Pivot paths are compared only where the walk is tie-free (the sample LP);
elsewhere the two packages may break fp32 ties differently, so status, z
(rel gap <= 1e-5 against HiGHS, the fp32 gate) and feas_err are compared.
"""

import subprocess
import sys

import numpy as np
import pytest
import scipy.sparse
import torch

import simplex_tpu
from simplex_tpu.oracle.generator import degenerate_streak_lp, random_dense_lp
from simplex_tpu.oracle.reference import relative_gap, solve_scipy
from simplex_tpu_torch import SimplexOptions, SolveStatus, load_lp, solve
from simplex_tpu_torch import cli
from simplex_tpu_torch.core.solver import solve_state
from simplex_tpu_torch.core.state import initial_state_slack, problem_from_numpy

SAMPLE = "tests/data/sample.txt"


@pytest.mark.parametrize("backend", ["hopper", "torch"])
def test_sample_matches_jax(backend):
    A, b, c = load_lp(SAMPLE)
    res = solve(A, b, c, options=SimplexOptions(backend=backend), device="cpu")
    ref = simplex_tpu.solve(*simplex_tpu.load_lp(SAMPLE))
    assert res.status == SolveStatus.OPTIMAL == int(ref.status)
    assert abs(res.z - 9.0) < 1e-6
    np.testing.assert_allclose(res.x, [1, 3, 0, 0], atol=1e-6)
    assert res.iters == ref.iters == 2
    np.testing.assert_array_equal(res.basis, ref.basis)
    np.testing.assert_allclose(res.y, ref.y, atol=1e-6)


@pytest.mark.parametrize("m,n,seed", [(64, 160, 0), (128, 512, 1)])
def test_random_dense_matches_jax_and_highs(m, n, seed):
    A, b, c = random_dense_lp(m, n, seed=seed)
    res = solve(A, b, c, device="cpu")
    ref_jax = simplex_tpu.solve(A, b, c)
    ref = solve_scipy(A, b, c)
    assert res.status == SolveStatus.OPTIMAL == int(ref_jax.status)
    assert relative_gap(res.z, ref.z) <= 1e-5
    assert relative_gap(res.z, ref_jax.z) <= 1e-5
    assert res.feas_err <= 1e-6 and ref_jax.feas_err <= 1e-6
    np.testing.assert_allclose(A @ res.x, b, atol=1e-4)


@pytest.mark.parametrize("seed", [5, 9])
def test_degenerate_streak_with_perturbation(seed):
    A, b, c = degenerate_streak_lp(seed=seed)
    opts = SimplexOptions(perturb_after=2, refactor_every=32)
    res = solve(A, b, c, options=opts, device="cpu")
    ref_jax = simplex_tpu.solve(
        A, b, c, options=simplex_tpu.SimplexOptions(perturb_after=2, refactor_every=32)
    )
    ref = solve_scipy(A, b, c)
    assert res.status == SolveStatus.OPTIMAL == int(ref_jax.status)
    assert relative_gap(res.z, ref.z) <= 1e-5
    assert relative_gap(res.z, ref_jax.z) <= 1e-5
    assert np.all(res.x >= -1e-6)
    # the perturbation fired, and was cleared before the answer was certified
    prob = problem_from_numpy(A, b, c, "cpu")
    final = solve_state(prob, initial_state_slack(prob, torch.float32, perturb=True), opts, 4096)
    assert int(final.status) == SolveStatus.OPTIMAL
    assert int(final.pert.rounds) >= 1 and not bool(final.pert.on)
    assert float(final.pert.w.abs().max()) == 0.0


def test_default_options_degenerate_lp():
    A, b, c = degenerate_streak_lp(seed=13)
    res = solve(A, b, c, device="cpu")
    ref = solve_scipy(A, b, c)
    assert res.status == SolveStatus.OPTIMAL
    assert relative_gap(res.z, ref.z) <= 1e-5


def test_max_iter_maps_running_status():
    A, b, c = random_dense_lp(32, 100, seed=2)
    res = solve(A, b, c, options=SimplexOptions(max_iter=3), device="cpu")
    ref = simplex_tpu.solve(A, b, c, options=simplex_tpu.SimplexOptions(max_iter=3))
    assert res.status == SolveStatus.MAX_ITER == int(ref.status)
    assert res.iters == ref.iters == 3


def test_unbounded_probe():
    A = np.array([[-1.0, 1.0, 1.0]])
    res = solve(A, np.array([1.0]), np.array([1.0, 0.0, 0.0]), device="cpu")
    ref = simplex_tpu.solve(A, np.array([1.0]), np.array([1.0, 0.0, 0.0]))
    assert res.status == SolveStatus.UNBOUNDED == int(ref.status)


def test_rejects_bad_shapes():
    with pytest.raises(ValueError, match="m > n"):
        solve(np.ones((3, 2)), np.ones(3), np.ones(2), device="cpu")
    with pytest.raises(ValueError, match="shape mismatch"):
        solve(np.ones((2, 4)), np.ones(3), np.ones(4), device="cpu")


def test_explicit_basis_matches_jax():
    A, b, c = random_dense_lp(16, 40, seed=4)
    basis0 = np.arange(24, 40)
    res = solve(A, b, c, basis0=basis0, device="cpu")
    ref = simplex_tpu.solve(A, b, c, basis0=basis0)
    assert res.status == SolveStatus.OPTIMAL == int(ref.status)
    assert relative_gap(res.z, ref.z) <= 1e-5


@pytest.mark.parametrize(
    "kwargs",
    [
        {"options": SimplexOptions(pricing_sparse=True, partial_pricing=8)},
        {"options": SimplexOptions(pricing_sparse=True)},
    ],
)
def test_unported_options_raise(kwargs):
    # pricing_sparse is ported: it solves, and refuses segmented pricing as
    # simplex_tpu.solve does
    A, b, c = load_lp(SAMPLE)
    if kwargs["options"].partial_pricing > 1:
        with pytest.raises(NotImplementedError, match="partial_pricing"):
            solve(A, b, c, device="cpu", **kwargs)
        with pytest.raises(NotImplementedError, match="partial_pricing"):
            simplex_tpu.solve(A, b, c, options=simplex_tpu.SimplexOptions(
                pricing_sparse=True, partial_pricing=8))
        return
    res = solve(A, b, c, device="cpu", **kwargs)
    ref = simplex_tpu.solve(A, b, c, options=simplex_tpu.SimplexOptions(pricing_sparse=True))
    assert res.status == SolveStatus.OPTIMAL == int(ref.status)
    assert res.iters == ref.iters and abs(res.z - 9.0) < 1e-5


@pytest.mark.parametrize(
    "kwargs",
    [
        {"options": SimplexOptions(pricing="devex")},
        {"options": SimplexOptions(pricing="steepest")},
        {"options": SimplexOptions(pricing="devex", multi_price=64)},
        {"options": SimplexOptions(pricing="steepest", update_defer=16)},
        {"u": np.full(4, 5.0), "options": SimplexOptions(pricing="devex")},
    ],
)
def test_weighted_pricing_options_solve(kwargs):
    # the option sets that raised before devex and steepest edge were
    # ported now solve (devex drops multi_price, as simplex_tpu.solve does)
    A, b, c = load_lp(SAMPLE)
    res = solve(A, b, c, device="cpu", **kwargs)
    ref = simplex_tpu.solve(A, b, c, u=kwargs.get("u"))
    assert res.status == SolveStatus.OPTIMAL == int(ref.status)
    assert relative_gap(res.z, ref.z) <= 1e-5 and abs(res.z - 9.0) < 1e-5


def test_sparse_and_unknown_backend_raise():
    # sparse A solves now (the same path as the JAX package's); an unknown
    # backend still raises
    A, b, c = load_lp(SAMPLE)
    res = solve(scipy.sparse.csr_matrix(A), b, c, device="cpu")
    ref = simplex_tpu.solve(scipy.sparse.csr_matrix(A), b, c)
    assert res.status == SolveStatus.OPTIMAL == int(ref.status)
    assert res.iters == ref.iters == 2 and abs(res.z - 9.0) < 1e-5
    np.testing.assert_array_equal(res.basis, ref.basis)
    with pytest.raises(ValueError, match="backend"):
        solve(A, b, c, options=SimplexOptions(backend="xla"), device="cpu")


def test_no_silent_cpu_fallback():
    # without a card the default device raises; with one it solves there
    A, b, c = load_lp(SAMPLE)
    if torch.cuda.is_available():
        assert abs(solve(A, b, c).z - 9.0) < 1e-5
    else:
        with pytest.raises((AssertionError, RuntimeError)):
            solve(A, b, c)


def test_cli_solve_sample(capsys):
    rc = cli.main(["solve", SAMPLE, "--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "Optimum found: 9" in out
    assert "x_0 = 1" in out and "x_1 = 3" in out


def test_import_leaves_jax_out():
    code = (
        "import sys, simplex_tpu_torch, simplex_tpu_torch.cli, "
        "simplex_tpu_torch.kernels.hopper, simplex_tpu_torch.oracle.generator, "
        "simplex_tpu_torch.oracle.reference, simplex_tpu_torch.fo.sharded, "
        "simplex_tpu_torch.dist.sharded2d, simplex_tpu_torch.dist.checkpoint2d, "
        "simplex_tpu_torch.dist.dryrun, simplex_tpu_torch.bench.sass_ops\n"
        "bad = [k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'simplex_tpu.'))]\n"
        "assert not bad, bad\n"
        "assert 'simplex_tpu' not in sys.modules\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
