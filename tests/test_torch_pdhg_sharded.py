"""The port's column-sharded PDHG against the JAX package's.

``simplex_tpu_torch.fo.sharded.solve_pdhg_sharded`` on 1 to 4 gloo CPU
ranks (one pool of four for the module; fewer ranks through meshes over
the first R) against ``simplex_tpu.fo.sharded.solve_pdhg_sharded`` on the
conftest's 8-device virtual mesh: dense, sparse (scipy CSC against the
reference's ``BlockSparse``) and boxed instances; budgets that end inside a
call of the reference's window loop; the infeasible and unbounded
certificates; uneven shards (n not divisible by the ranks, which the
reference refuses) against the reference on one device. Status equal and z
within 1e-4 relative; every rank returns the same result. One window from
a carried reference state: the iterates to rtol 1e-5, the running sums to
1e-4 (the single card's PDHG test's tolerances). Collectives: one SUM an
iteration, one SUM and one MAX a window's check. The exit certificate's
products on the shards against the single card's on the whole A (float64,
rtol 1e-12), and no whole copy of a large A for them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps

from simplex_tpu import sparse as jsparse
from simplex_tpu.dist.mesh import COLS_AXIS
from simplex_tpu.dist.mesh import make_mesh as jax_make_mesh
from simplex_tpu.fo import sharded as jsh
from simplex_tpu_torch import SolveStatus
from simplex_tpu_torch.oracle.generator import random_dense_lp
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy
from torch_dist_ranks import RankPool


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def jmesh(R):
    assert len(jax.devices()) == 8
    return jax_make_mesh(axis_names=(COLS_AXIS,), devices=jax.devices()[:R])


def sharded(pool, R, A, b, c, **kw):
    """The run on R ranks, every rank's result equal to rank 0's; rank 0's
    record."""
    out = pool.run("pdhg_sharded", R, A, b, c, kw)[:R]
    r0 = out[0]["res"]
    for rec in out[1:]:
        r = rec["res"]
        assert (r.status, r.iters, r.z, r.primal_res, r.dual_res, r.gap) == (
            r0.status, r0.iters, r0.z, r0.primal_res, r0.dual_res, r0.gap)
        np.testing.assert_array_equal(r.x, r0.x)
        np.testing.assert_array_equal(r.y, r0.y)
    return out[0]


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


def agree(res, jres, ref_z=None, gap=1e-4):
    assert res.status == int(jres.status), (res.status, jres.status)
    assert relative_gap(res.z, float(jres.z)) < gap
    if ref_z is not None:
        assert relative_gap(res.z, ref_z) < 1e-3


@pytest.mark.parametrize("R", [1, 2, 4])
def test_dense_matches_jax(pool, R):
    A, b, c = random_dense_lp(16, 64, seed=2, dtype=np.float32)
    rec = sharded(pool, R, A, b, c, tol=1e-5)
    res = rec["res"]
    jres = jsh.solve_pdhg_sharded(A, b, c, jmesh(R), tol=1e-5)
    agree(res, jres, solve_scipy(A, b, c).z)
    assert res.status == SolveStatus.OPTIMAL and res.iters == int(jres.iters)
    col = rec["collectives"]
    windows = res.iters // 128
    assert col["pdhg_matvec"] == res.iters  # one SUM an iteration
    assert col["pdhg_kkt"] == 2 * windows  # one SUM and one MAX a window


@pytest.mark.parametrize("R", [2, 4])
def test_sparse_matches_jax(pool, R):
    A, b, c = random_dense_lp(16, 64, seed=3, dtype=np.float32)
    res = sharded(pool, R, sps.csc_matrix(A), b, c, tol=1e-5)["res"]
    jres = jsh.solve_pdhg_sharded(jsparse.from_dense(A, block_shape=(8, 8)), b, c, jmesh(R), tol=1e-5)
    agree(res, jres, solve_scipy(A, b, c).z)


@pytest.mark.parametrize("R", [2, 4])
def test_boxed_matches_jax(pool, R):
    A, b, c, u = boxed(8, 20, 11)
    res = sharded(pool, R, A, b, c, u=u, tol=1e-6, max_iter=400_000)["res"]
    jres = jsh.solve_pdhg_sharded(A, b, c, jmesh(R), u=u, tol=1e-6, max_iter=400_000)
    agree(res, jres)
    assert res.status == SolveStatus.OPTIMAL
    assert np.all(res.x <= np.asarray(u, np.float64) + 1e-4)


@pytest.mark.parametrize("check_every,max_iter", [(64, 1000), (128, 300)])
def test_budget_ends_inside_a_call(pool, check_every, max_iter):
    # the reference runs many windows a device call and stops on the same
    # test a window; the budget is checked before each window
    A, b, c = random_dense_lp(16, 40, seed=8, dtype=np.float32)
    res = sharded(pool, 2, A, b, c, tol=1e-12, max_iter=max_iter, check_every=check_every)["res"]
    jres = jsh.solve_pdhg_sharded(A, b, c, jmesh(2), tol=1e-12, max_iter=max_iter, check_every=check_every)
    assert res.status == int(jres.status) and res.status in (SolveStatus.MAX_ITER, SolveStatus.SINGULAR)
    assert res.iters == int(jres.iters) == -(-max_iter // check_every) * check_every
    np.testing.assert_allclose(res.x, np.asarray(jres.x), rtol=1e-3, atol=1e-4)


CERT_CASES = {
    "infeasible": ([[1.0, 1.0]], [-1.0], [1.0, 1.0], 2, SolveStatus.INFEASIBLE),
    "unbounded": ([[-1.0, 1.0, 1.0]], [1.0], [1.0, 0.0, 0.0], 3, SolveStatus.UNBOUNDED),
}


@pytest.mark.parametrize("case", list(CERT_CASES))
def test_certificates(pool, case):
    A, b, c, R, want = CERT_CASES[case]
    A, b, c = (np.asarray(v, np.float32) for v in (A, b, c))
    res = sharded(pool, R, A, b, c, tol=1e-6, max_iter=100_000)["res"]
    jres = jsh.solve_pdhg_sharded(A, b, c, jmesh(R), tol=1e-6, max_iter=100_000)
    assert res.status == int(jres.status) == want
    A64 = np.asarray(A, np.float64)
    if want == SolveStatus.INFEASIBLE:
        r = res.ray_dual
        assert r is not None and res.ray_primal is None and float(b @ r) > 0
        assert np.max(A64.T @ r) <= 1e-5 * float(b @ r)
    else:
        d = res.ray_primal
        assert d is not None and res.ray_dual is None and d.min() >= 0
        assert float(c @ d) > 0 and np.max(np.abs(A64 @ d)) <= 1e-5 * float(c @ d)


@pytest.mark.parametrize("R", [3, 4])
def test_uneven_shards(pool, R):
    # n = 50 over 3 or 4 ranks: shards of 17/17/16 or 13/13/12/12 columns
    A, b, c = random_dense_lp(12, 50, seed=5, dtype=np.float32)
    with pytest.raises(ValueError, match="divisible"):
        jsh.solve_pdhg_sharded(A, b, c, jmesh(R), tol=1e-5)
    res = sharded(pool, R, A, b, c, tol=1e-5)["res"]
    one = sharded(pool, 1, A, b, c, tol=1e-5)["res"]
    jres = jsh.solve_pdhg_sharded(A, b, c, jmesh(1), tol=1e-5)
    agree(res, jres, solve_scipy(A, b, c).z)
    agree(one, jres)


WINDOW = 64  # iterations a check window (the single card's window test's)


def jax_setup(A, b, c, u, R, windows):
    """The reference's set-up on R devices, and its state after ``windows``
    check windows and after one more: (scaled data, state, next state) as
    numpy (data by name, states as the 15 leaves)."""
    mesh = jmesh(R)
    setup, chunk = jsh._build_fns(mesh, COLS_AXIS, 1e-12, WINDOW, max(windows, 1))
    As, dr, dc, bs, cs, tau, sigma, b_scale, c_scale = setup(jnp.asarray(A), jnp.asarray(b), jnp.asarray(c))
    us = jnp.asarray(u, jnp.float32) * dc
    m, n = A.shape
    dt, inf = jnp.float32, jnp.asarray(jnp.inf, jnp.float32)
    state = (
        jnp.zeros(n, dt), jnp.zeros(m, dt), jnp.int32(0), inf, jnp.int32(0), jnp.zeros(n, dt), inf, inf,
        inf, jnp.int32(0), jnp.zeros(m, dt), tau, sigma, jnp.zeros(n, dt), jnp.zeros(m, dt),
    )
    if windows:
        state = chunk(As, bs, cs, dr, dc, b_scale, c_scale, us, state, jnp.int32(10**9))
    _, one = jsh._build_fns(mesh, COLS_AXIS, 1e-12, WINDOW, 1)
    nxt = one(As, bs, cs, dr, dc, b_scale, c_scale, us, state, jnp.int32(10**9))
    data = dict(As=As, bs=bs, cs=cs, dr=dr, dc=dc, b_scale=b_scale, c_scale=c_scale, us=us, tau=tau, sigma=sigma)
    return ({k: np.asarray(v) for k, v in data.items()}, [np.asarray(v) for v in state],
            [np.asarray(v) for v in nxt])


@pytest.mark.parametrize("bounded", [False, True])
def test_setup_matches_jax(pool, bounded):
    if bounded:
        A, b, c, u = boxed(8, 20, 11)
    else:
        A, b, c = random_dense_lp(16, 64, seed=1, dtype=np.float32)
        u = np.full(A.shape[1], np.inf, np.float32)
    want, _, _ = jax_setup(A, b, c, u, 2, 0)
    for rank, (got, (lo, hi)) in enumerate(pool.run("pdhg_sharded_setup", 2, A, b, c, u)[:2]):
        for name, v in zip(("As", "bs", "cs", "dr", "dc", "b_scale", "c_scale", "us", "tau", "sigma"), got):
            w = want[name][..., lo:hi] if name in ("As", "cs", "dc", "us") else want[name]
            np.testing.assert_allclose(v, w, rtol=1e-5, atol=1e-7, err_msg=f"rank {rank} {name}")


@pytest.mark.parametrize("bounded", [False, True])
@pytest.mark.parametrize("windows_before", [0, 3])
def test_one_window_from_a_carried_state(pool, bounded, windows_before):
    if bounded:
        A, b, c, u = boxed(8, 20, 11)
    else:
        A, b, c = random_dense_lp(16, 64, seed=1, dtype=np.float32)
        u = np.full(A.shape[1], np.inf, np.float32)
    R = 2 if bounded else 4
    data, state, nxt = jax_setup(A, b, c, u, R, windows_before)
    got = pool.run("pdhg_sharded_window", R, data, state, 1e-12, WINDOW)[0]
    for name, want in zip(("x", "y", "cnt", "lre", "it", "sx", "rp", "rd", "gp", "stall", "sy", "tau", "sigma",
                           "xr", "yr"), nxt):
        # the iterates and scalars to rtol 1e-5; the window's running sums
        # add 64 iterates, and an entry that crosses the projection's kink
        # in one package and not the other drifts by ~3e-5 of itself
        rtol = 1e-4 if name in ("sx", "sy") else 1e-5
        np.testing.assert_allclose(got[name], want, rtol=rtol, atol=1e-6, err_msg=name)


# --------------------------------------------------------------------------
# the exit certificate's products on the shards
# --------------------------------------------------------------------------


@pytest.mark.parametrize("sparse", [False, True])
@pytest.mark.parametrize("R", [1, 2, 4])
def test_certificate_products_match_the_whole_matrix(pool, R, sparse):
    # each rank's columns with one SUM (A xhat; the bounds' share) and one
    # MAX (the violation) equal the single card's products on the whole A
    from simplex_tpu_torch.fo.pdhg import _HostCert

    A, b, c, u = boxed(12, 29, 5)  # 41 columns: uneven over 2 and 4 ranks
    rng = np.random.default_rng(0)
    rays = [(np.where(np.isfinite(u), 0, rng.uniform(0, 1, 41)), rng.uniform(-1, 1, 12)) for _ in range(3)]
    A_in = sps.csc_matrix(A) if sparse else A
    out = pool.run("pdhg_cert_products", R, A_in, b, c, u.astype(np.float64), rays)[:R]
    whole = _HostCert(A.astype(np.float64), b.astype(np.float64), -c.astype(np.float64), u.astype(np.float64))
    for (x, y), got in zip(rays, out[0]):
        np.testing.assert_allclose(got[0], whole.primal(x), rtol=1e-12)
        np.testing.assert_allclose(got[1], whole.dual(y), rtol=1e-12)
        np.testing.assert_allclose(got[2], whole.polish(x, ~np.isfinite(u)), rtol=1e-12, atol=1e-15)
    for rank in out[1:]:
        for mine, first in zip(rank, out[0]):
            assert mine[:2] == first[:2]  # every rank the same numbers, bit for bit


class _ColumnsOnly:
    """A dense A that hands out blocks of columns and nothing whole."""

    def __init__(self, A):
        self.A, self.shape, self.taken = A, A.shape, []

    def __getitem__(self, key):
        rows, cols = key
        assert rows == slice(None) and isinstance(cols, slice)
        self.taken.append(cols.stop - cols.start)
        return self.A[:, cols]

    def __array__(self, *a, **k):
        raise AssertionError("the whole A was taken")


def test_certificate_takes_blocks_of_columns(monkeypatch):
    # a rank's products read its own columns a block at a time; the polish
    # (the single card's, up to 2^24 entries) leaves a larger A untouched
    from simplex_tpu_torch.fo import sharded as fs

    monkeypatch.setattr(fs, "CERT_BLOCK", 64)
    monkeypatch.setattr(fs, "all_reduce", lambda t, op, group, name: t)  # one rank, no group
    A, b, c, u = boxed(8, 40, 2)
    big = _ColumnsOnly(A)
    ops = fs._ShardCert(fs._Shard(None, 10, 48), big, b.astype(np.float64), -c.astype(np.float64),
                        u.astype(np.float64), "cpu")
    x, y = np.where(np.isfinite(u), 0.0, 1.0), np.ones(8)
    viol, obj = ops.primal(x)
    assert viol == pytest.approx(np.abs(A[:, 10:48] @ x[10:48]).max(), rel=1e-12)
    ops.dual(y)
    assert big.taken and max(big.taken) == 64 // 8
    big.shape = (1 << 12, 1 << 13)  # 2^25 entries: past the polish's limit
    d = np.ones(48)
    assert ops.polish(d, np.zeros(48, bool)) is d


def test_card_check_pdhg_rehearses_on_cpu_ranks(tmp_path):
    # --mode pdhg's flow on two gloo CPU ranks: the ranks' states agree, the
    # KKT errors match the world-1 run's, the entry ends at MAX_ITER
    import json

    from simplex_tpu_torch.dist import card_check

    out = tmp_path / "ccp.json"
    rc = card_check.main(["--device", "cpu", "--mode", "pdhg", "--ranks", "2", "--m", "24", "--n", "80",
                          "--window", "256", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc == 0 and rec["ranks_agree"] and rec["kkt_diff_from_world1"] <= rec["kkt_tol"]
    assert rec["max_iter_run"]["status"] == "MAX_ITER" and rec["max_iter_run"]["iters"] == card_check.PDHG_MAX_ITER
    # the timed windows and the profiled one: one SUM an iteration
    assert rec["sharded_collectives"]["pdhg_matvec"] == 256 + card_check.PDHG_WINDOW
