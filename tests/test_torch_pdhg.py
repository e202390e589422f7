"""The port's PDHG and crossover against the JAX package's.

``simplex_tpu_torch.fo`` against ``simplex_tpu.fo`` on the CPU at the
sizes of ``tests/test_pdhg.py``: one check window from a carried JAX state
(iterates to rtol 1e-5); whole solves by status, z and the KKT residuals
(iteration counts are not held: the packages reduce in other orders); the
infeasible, unbounded and bounded certificates; crossover to the vertex;
and ``cli solve --algo pdhg``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch
from scipy.optimize import linprog

from simplex_tpu.fo import pdhg as jpdhg
from simplex_tpu.fo import solve_pdhg as jax_solve_pdhg
from simplex_tpu.fo.crossover import crossover as jax_crossover
from simplex_tpu.fo.crossover import identify_basis as jax_identify_basis
from simplex_tpu.io.text import load_lp
from simplex_tpu.oracle.generator import multiperiod_production_lp, random_dense_lp
from simplex_tpu.oracle.reference import relative_gap, solve_scipy, solve_scipy_general
from simplex_tpu_torch import SimplexOptions, SolveStatus, cli, crossover, solve_pdhg
from simplex_tpu_torch.fo import pdhg
from simplex_tpu_torch.fo.crossover import identify_basis
from simplex_tpu_torch.io.canonical import to_equality_form

SAMPLE = "tests/data/sample.txt"


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the suite's worker processes share the cores,
    and a torch parallel region (a sparse product enters one on every
    call) waits for threads that are not scheduled."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def boxed(m, k, seed):
    """[A0 | I] x = b, 0 <= x <= u on the structurals (``tests/test_pdhg.py``'s
    bounded instances)."""
    rng = np.random.default_rng(seed)
    A0 = rng.uniform(0.2, 1.5, (m, k))
    A = np.hstack([A0, np.eye(m)]).astype(np.float32)
    b = (A0 @ rng.uniform(0.2, 0.8, k) + rng.uniform(0.1, 1.0, m)).astype(np.float32)
    c = np.concatenate([rng.uniform(0.5, 2, k), np.zeros(m)]).astype(np.float32)
    u = np.concatenate([rng.uniform(0.3, 1.0, k), np.full(m, np.inf)]).astype(np.float32)
    return A, b, c, u


def highs_boxed(A, b, c, u):
    r = linprog(-np.asarray(c, np.float64), A_eq=np.asarray(A, np.float64),
                b_eq=np.asarray(b, np.float64),
                bounds=[(0, float(v) if np.isfinite(v) else None) for v in u], method="highs")
    assert r.status == 0
    return -r.fun


# --------------------------------------------------------------------------
# one window from a carried state
# --------------------------------------------------------------------------


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("windows_before", [0, 3])
def test_one_window_from_a_carried_state(bounded, windows_before):
    if bounded:
        A, b, c, u = boxed(8, 20, 11)
    else:
        A, b, c = random_dense_lp(24, 64, seed=1)
        u = np.full(A.shape[1], np.inf, np.float32)
    cmin = (-c).astype(np.float32)
    js = jpdhg._pdhg_setup(jnp.asarray(A), jnp.asarray(b), jnp.asarray(cmin), jnp.float32)
    As, dr, dc, bs, cs, tau0, sigma0, b_scale, c_scale = js
    us = jnp.asarray(u, jnp.float32) * dc
    m, n = A.shape
    inf = jnp.asarray(jnp.inf, jnp.float32)
    state = (jnp.zeros(n), jnp.zeros(m), jnp.zeros(n), jnp.zeros(m), jnp.int32(0), inf,
             jnp.int32(0), inf, inf, inf, jnp.int32(0), tau0, sigma0, jnp.zeros(n), jnp.zeros(m))
    state = tuple(jnp.asarray(v, jnp.float32) if i not in (4, 6, 10) else v for i, v in enumerate(state))
    for _ in range(windows_before):
        state = jpdhg._pdhg_chunk(As, bs, cs, dr, dc, b_scale, c_scale, us, state,
                                  1e-12, 10**9, 64, 1, True)
    nxt = jpdhg._pdhg_chunk(As, bs, cs, dr, dc, b_scale, c_scale, us, state, 1e-12, 10**9, 64, 1, True)

    def t(v):
        return torch.as_tensor(np.asarray(v))

    ts = pdhg.pdhg_state_from_numpy([np.asarray(v) for v in state], "cpu")
    got = pdhg._pdhg_window(t(As), t(bs), t(cs), t(dr), t(dc), t(b_scale), t(c_scale), t(us),
                            ts, 1e-12, 64, True)
    for name, a, b_ in zip(pdhg.STATE_LEAVES, got, nxt):
        # the iterates and scalars to rtol 1e-5; the window's running sums
        # (sx, sy) add 64 iterates, and an entry that crosses the projection's
        # kink in one package and not the other drifts by ~3e-5 of itself
        rtol = 1e-4 if name in ("sx", "sy") else 1e-5
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=rtol, atol=1e-6, err_msg=name)


def test_setup_matches_jax():
    A, b, c = random_dense_lp(24, 64, seed=2)
    cmin = (-c).astype(np.float32)
    want = jpdhg._pdhg_setup(jnp.asarray(A), jnp.asarray(b), jnp.asarray(cmin), jnp.float32)
    got = pdhg._pdhg_setup(torch.as_tensor(A), torch.as_tensor(b), torch.as_tensor(cmin), torch.float32)
    for a, b_ in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b_), rtol=1e-5, atol=1e-7)
    # the sparse ops give the same scaled system
    got_sp = pdhg._pdhg_setup(
        pdhg._as_device_A(sps.csr_matrix(A), torch.float32, "cpu"), torch.as_tensor(b),
        torch.as_tensor(cmin), torch.float32,
    )
    np.testing.assert_allclose(got_sp[0].to_dense().numpy(), got[0].numpy(), rtol=1e-5, atol=1e-7)
    for a, b_ in zip(got_sp[1:], got[1:]):
        np.testing.assert_allclose(a.numpy(), b_.numpy(), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------------------
# whole solves
# --------------------------------------------------------------------------


def check_against_jax(res, jres, tol, ref_z=None, gap=1e-3):
    assert res.status == jres.status == SolveStatus.OPTIMAL, (res.status, jres.status)
    assert max(res.primal_res, res.dual_res, res.gap) < tol
    assert relative_gap(res.z, jres.z) < gap
    if ref_z is not None:
        assert relative_gap(res.z, ref_z) < gap


@pytest.mark.parametrize("storage", ["dense", "scipy"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_solve_matches_jax_moderate_tol(storage, seed):
    A, b, c = random_dense_lp(24, 64, seed=seed)
    A_in = A if storage == "dense" else sps.csr_matrix(A)
    res = solve_pdhg(A_in, b, c, tol=1e-4, device="cpu")
    check_against_jax(res, jax_solve_pdhg(A, b, c, tol=1e-4), 1e-4, solve_scipy(A, b, c).z)
    assert np.abs(A @ res.x - b).max() < 1e-2 and res.x.min() > -1e-6


def test_a_tensor_is_used_in_place(monkeypatch):
    """A dense A given as a tensor on the solve's device goes in as it is
    (never turned into a host array); the answer is the numpy input's."""
    A, b, c = random_dense_lp(24, 64, seed=0)
    want = solve_pdhg(A, b, c, tol=1e-4, device="cpu")

    def no_host_copy(self, *a, **k):
        raise AssertionError("A was turned into a host array")

    monkeypatch.setattr(torch.Tensor, "__array__", no_host_copy)
    got = solve_pdhg(torch.from_numpy(np.asarray(A, np.float32)), b, c, tol=1e-4, device="cpu")
    monkeypatch.undo()
    assert (got.status, got.iters, got.z) == (want.status, want.iters, want.z)
    np.testing.assert_array_equal(got.x, want.x)


@pytest.mark.parametrize("seed", [1, 2])
def test_solve_tight_tol(seed):
    A, b, c = random_dense_lp(24, 64, seed=seed)
    res = solve_pdhg(A, b, c, tol=1e-6, device="cpu")
    check_against_jax(res, jax_solve_pdhg(A, b, c, tol=1e-6), 1e-6, solve_scipy(A, b, c).z, 1e-5)


def test_solve_float64_and_fixed_weight():
    A, b, c = random_dense_lp(24, 64, seed=1)
    ref = solve_scipy(A, b, c).z
    res = solve_pdhg(A, b, c, tol=1e-6, dtype=torch.float64, device="cpu")
    check_against_jax(res, jax_solve_pdhg(A, b, c, tol=1e-6, dtype=jnp.float64), 1e-6, ref, 1e-5)
    fixed = solve_pdhg(A, b, c, tol=1e-6, adaptive_weight=False, device="cpu")
    check_against_jax(fixed, jax_solve_pdhg(A, b, c, tol=1e-6, adaptive_weight=False), 1e-6, ref, 1e-5)


def test_sample_golden():
    A, b, c = load_lp(SAMPLE)
    res = solve_pdhg(A, b, c, tol=1e-7, device="cpu")
    assert res.status == SolveStatus.OPTIMAL and abs(res.z - 9.0) < 1e-4


def test_badly_scaled():
    A, b, c = random_dense_lp(16, 40, seed=5)
    A = np.asarray(A, np.float64).copy()
    A *= np.logspace(-3, 3, A.shape[1])[None, :]
    A[:, -16:] = np.eye(16)
    res = solve_pdhg(A, b, c, tol=1e-5, device="cpu")
    assert res.status == SolveStatus.OPTIMAL
    assert relative_gap(res.z, solve_scipy(A, b, c).z) < 1e-3


@pytest.mark.parametrize("storage", ["dense", "scipy"])
def test_native_bounds(storage):
    A, b, c, u = boxed(8, 20, 11)
    A_in = A if storage == "dense" else sps.csc_matrix(A)
    res = solve_pdhg(A_in, b, c, u=u, tol=1e-6, max_iter=400_000, device="cpu")
    jres = jax_solve_pdhg(A, b, c, u=u, tol=1e-6, max_iter=400_000)
    check_against_jax(res, jres, 1e-6, highs_boxed(A, b, c, u))
    assert np.all(res.x <= np.asarray(u, np.float64) + 1e-4)


def test_multiperiod_sparse_equality_form():
    """``bench.py --mode pdhg --sparse``'s class (multiperiod, P = 32) at a
    test's size, through the box-bounded equality form, against HiGHS."""
    lp = multiperiod_production_lp(4, 32, seed=0)
    eq = to_equality_form(lp)
    A, b, c, u = (np.asarray(v, np.float32) for v in (eq.A, eq.b, eq.c, eq.u))
    res = solve_pdhg(sps.csr_matrix(A), b, c, u=u, tol=1e-4, device="cpu")
    jres = jax_solve_pdhg(A, b, c, u=u, tol=1e-4)
    check_against_jax(res, jres, 1e-4, solve_scipy_general(lp).z - eq.z_const)


# --------------------------------------------------------------------------
# certificates and non-convergent exits
# --------------------------------------------------------------------------


CERT_CASES = {
    "infeasible": ([[1.0, 1.0]], [-1.0], [1.0, 1.0], None, SolveStatus.INFEASIBLE),
    "unbounded": ([[-1.0, 1.0, 1.0]], [1.0], [1.0, 0.0, 0.0], None, SolveStatus.UNBOUNDED),
    "bounded infeasible": ([[1.0, 1.0]], [5.0], [1.0, 1.0], [1.0, 1.0], SolveStatus.INFEASIBLE),
}


@pytest.mark.parametrize("case", list(CERT_CASES))
def test_certificates(case):
    A, b, c, u, want = CERT_CASES[case]
    A, b, c = (np.asarray(v, np.float32) for v in (A, b, c))
    u = None if u is None else np.asarray(u, np.float32)
    res = solve_pdhg(A, b, c, u=u, tol=1e-6, max_iter=100_000 if u is None else 200_000, device="cpu")
    jres = jax_solve_pdhg(A, b, c, u=u, tol=1e-6, max_iter=100_000 if u is None else 200_000)
    assert res.status == jres.status == want, (res.status, jres.status)
    A64 = np.asarray(A, np.float64)
    if want == SolveStatus.INFEASIBLE:
        r = res.ray_dual
        assert r is not None and res.ray_primal is None
        assert np.max(np.abs(r)) == pytest.approx(1.0)
        aty = A64.T @ r
        lhs = float(b @ r) - (0.0 if u is None else float(u @ np.maximum(aty, 0)))
        assert lhs > 0
        if u is None:
            assert np.max(aty) <= 1e-5 * float(b @ r)
    else:
        d = res.ray_primal
        assert d is not None and res.ray_dual is None and d.min() >= 0
        cd = float(c @ d)
        assert cd > 0 and np.max(np.abs(A64 @ d)) <= 1e-5 * cd


def test_bounded_ray_is_capped_not_unbounded():
    A = np.array([[-1.0, 1.0, 1.0]], np.float32)
    b = np.array([1.0], np.float32)
    c = np.array([1.0, 0.0, 0.0], np.float32)
    u = np.array([10.0, np.inf, np.inf], np.float32)
    res = solve_pdhg(A, b, c, u=u, tol=1e-6, max_iter=400_000, device="cpu")
    assert res.status == SolveStatus.OPTIMAL and abs(res.z - 10.0) < 1e-2


def test_budget_exhaustion():
    A, b, c = random_dense_lp(16, 40, seed=8)
    res = solve_pdhg(A, b, c, tol=1e-12, max_iter=256, device="cpu")
    jres = jax_solve_pdhg(A, b, c, tol=1e-12, max_iter=256)
    assert res.status == jres.status and res.status in (SolveStatus.MAX_ITER, SolveStatus.SINGULAR)
    assert res.iters == 256


def test_rejects_bad_input():
    A, b, c = random_dense_lp(4, 10, seed=0)
    with pytest.raises(ValueError, match="negative upper bound"):
        solve_pdhg(A, b, c, u=-np.ones(10), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        solve_pdhg(A, b, c, dtype=torch.float16, device="cpu")
    # the sharded PDHG is ported (tests/test_torch_pdhg_sharded.py)
    from simplex_tpu_torch.fo import solve_pdhg_sharded

    assert callable(solve_pdhg_sharded)


# --------------------------------------------------------------------------
# crossover
# --------------------------------------------------------------------------


def test_identify_basis_matches_jax():
    A, b, c, u = boxed(10, 24, 33)
    fo = jax_solve_pdhg(A, b, c, u=u, tol=1e-5, max_iter=600_000)
    basis, up = identify_basis(A, fo.x, u=u)
    jbasis, jup = jax_identify_basis(A, fo.x, u=u)
    np.testing.assert_array_equal(basis, jbasis)
    np.testing.assert_array_equal(up, jup)


@pytest.mark.parametrize("bounded", [False, True])
def test_crossover_purifies_to_the_vertex(bounded):
    if bounded:
        A, b, c, u = boxed(10, 24, 33)
        ref = highs_boxed(A, b, c, u)
        fo = solve_pdhg(A, b, c, u=u, tol=1e-5, max_iter=600_000, device="cpu")
    else:
        A, b, c = random_dense_lp(32, 80, seed=2)
        u = None
        ref = solve_scipy(A, b, c).z
        fo = solve_pdhg(A, b, c, tol=1e-5, device="cpu")
    assert fo.status == SolveStatus.OPTIMAL
    opts = SimplexOptions(refactor_every=64)
    res = crossover(A, b, c, fo, u=u, options=opts, device="cpu")
    jres = jax_crossover(A, b, c, fo, u=u)
    assert res.status == jres.status == SolveStatus.OPTIMAL
    assert relative_gap(res.z, ref) < 1e-6 and res.feas_err < 1e-4
    assert relative_gap(res.z, jres.z) < 1e-6
    if not bounded:
        cold = solve_scipy(A, b, c)
        assert cold.status == SolveStatus.OPTIMAL and res.iters <= 40


# --------------------------------------------------------------------------
# the CLI
# --------------------------------------------------------------------------


@pytest.mark.parametrize(
    "argv, want",
    [
        (["solve", SAMPLE, "--algo", "pdhg", "--pdhg-tol", "1e-7"], "Optimum found: 9"),
        (["solve", SAMPLE, "--algo", "pdhg", "--crossover"], "Optimum found: 9\n"),
        (["solve", "tests/data/prod_bounded.mps", "--algo", "pdhg", "--crossover"], "Optimum found: 15.25\n"),
    ],
)
def test_cli_solve_pdhg(capsys, argv, want):
    rc = cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    assert rc == 0 and want in out and "Pivots:" in out


def test_cli_matches_the_jax_cli(capsys):
    from simplex_tpu import cli as jax_cli

    argv = ["solve", SAMPLE, "--algo", "pdhg", "--crossover"]
    assert cli.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert jax_cli.main(argv) == 0
    out_j = capsys.readouterr().out
    assert out.splitlines()[:3] == out_j.splitlines()[:3]


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    A, b, c = random_dense_lp(4, 10, seed=0)
    with pytest.raises((RuntimeError, AssertionError)):
        solve_pdhg(A, b, c)

