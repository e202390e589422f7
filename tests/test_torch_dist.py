"""The port's column-sharded solve against the JAX package's.

``simplex_tpu_torch.dist.sharded.solve_sharded`` on 1 to 4 gloo CPU ranks
(one pool of four spawned once for the module; fewer ranks through meshes
over the first R) against ``simplex_tpu.dist.sharded.solve_sharded`` on the
conftest's 8-device virtual mesh, the port's single ``solve`` and HiGHS:
the cases of ``tests/test_dist.py`` one for one, with devex, deferred
updates and sparse A as ``tests/test_devex.py``, ``test_deferred_update.py``
and ``test_sparse_general.py`` run them. Tolerances are theirs: z within
1e-5 of HiGHS (1e-4 under deferred updates), within 1e-9 relative of the
single solve after the f64 polish, y within 1e-4. Every rank must return
the same result, bit for bit; on tie-free instances (and the duplicated
column) the pivot path is the single solve's.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.dist.mesh import COLS_AXIS
from simplex_tpu.dist.mesh import make_mesh as jax_make_mesh
from simplex_tpu.dist.sharded import solve_sharded as jax_solve_sharded
from simplex_tpu_torch import SimplexOptions, SolveStatus, solve
from simplex_tpu_torch.dist import mesh as tmesh
from simplex_tpu_torch.dist import sharded as tsh
from simplex_tpu_torch.oracle.generator import degenerate_streak_lp, random_dense_lp
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy
from simplex_tpu_torch.sparse import from_scipy
from torch_dist_ranks import RankPool


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def jmesh():
    assert len(jax.devices()) == 8
    return jax_make_mesh(axis_names=(COLS_AXIS,))


def lp(m, n, seed):
    return random_dense_lp(m, n, seed=seed, dtype=np.float32)


def sharded(pool, R, A, b, c, options=SimplexOptions(backend="torch"), basis0=None):
    """The run on R ranks; every rank's result equal to rank 0's, bit for
    bit. Returns rank 0's record."""
    out = pool.run("sharded", R, A, b, c, options, basis0)[:R]
    r0 = out[0]["res"]
    for rec in out[1:]:
        r = rec["res"]
        assert (r.status, r.iters, r.z, r.feas_err) == (r0.status, r0.iters, r0.z, r0.feas_err)
        for f in ("basis", "x", "x_b", "y"):
            np.testing.assert_array_equal(getattr(r, f), getattr(r0, f))
    return out[0]


def single(A, b, c, options):
    return solve(A, b, c, options=options, device="cpu")


BACKENDS = ["torch", "hopper"]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("R", [1, 2, 3, 4])
def test_sharded_matches_single_device(pool, jmesh, R, backend):
    # tests/test_dist.py::test_sharded_matches_single_device
    A, b, c = lp(16, 48, 21)
    opts = SimplexOptions(backend=backend)
    rec = sharded(pool, R, A, b, c, opts)
    res, ref = rec["res"], single(A, b, c, opts)
    jres = jax_solve_sharded(A, b, c, jmesh)
    assert res.status == ref.status == SolveStatus.OPTIMAL == int(jres.status)
    # the same pivot path as the single solve, and the same polished answer
    assert res.iters == ref.iters == int(jres.iters)
    np.testing.assert_array_equal(res.basis, ref.basis)
    np.testing.assert_array_equal(np.sort(res.basis), np.sort(np.asarray(jres.basis)))
    assert res.z == ref.z
    assert res.z == pytest.approx(jres.z, rel=1e-5)


@pytest.mark.parametrize("R", [2, 4])
def test_sharded_matches_oracle(pool, R):
    A, b, c = lp(32, 96, 22)
    res = sharded(pool, R, A, b, c)["res"]
    assert res.status == SolveStatus.OPTIMAL
    assert relative_gap(res.z, solve_scipy(A, b, c).z) < 1e-5


@pytest.mark.parametrize("R", [2, 3])
def test_sharded_unbounded(pool, R):
    A = np.zeros((2, 8), np.float32)
    A[:, :2] = [[-1.0, 1.0], [-1.0, 0.0]]
    A[:, 2:4] = np.eye(2)
    b = np.array([1.0, 2.0], np.float32)
    c = np.zeros(8, np.float32)
    c[0] = 1.0
    c[4:] = -1.0
    res = sharded(pool, R, A, b, c, basis0=np.array([2, 3]))["res"]
    assert res.status == SolveStatus.UNBOUNDED


def test_sharded_refactor_path(pool, jmesh):
    A, b, c = lp(24, 64, 23)
    ref = solve_scipy(A, b, c)
    res = sharded(pool, 4, A, b, c, SimplexOptions(refactor_every=16, backend="torch"))["res"]
    jres = jax_solve_sharded(A, b, c, jmesh, options=JaxOptions(refactor_every=16))
    assert res.status == SolveStatus.OPTIMAL == int(jres.status)
    assert relative_gap(res.z, ref.z) < 1e-5
    assert res.iters == int(jres.iters)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("R", [2, 3, 4])
def test_sharded_entering_choice_matches_local(pool, jmesh, R, backend):
    # a duplicated column ties two reduced costs exactly, on two ranks: the
    # lowest global index must win, as in the single solve and in JAX
    A, b, c = lp(8, 24, 24)
    A[:, 5] = A[:, 3]
    c[5] = c[3]
    opts = SimplexOptions(backend=backend)
    res = sharded(pool, R, A, b, c, opts)["res"]
    ref = single(A, b, c, opts)
    jres = jax_solve_sharded(A, b, c, jmesh)
    assert res.iters == ref.iters == int(jres.iters)
    np.testing.assert_array_equal(res.basis, ref.basis)
    np.testing.assert_array_equal(res.basis, np.asarray(jres.basis))


FLAGSHIP = dict(
    pricing_dtype="bfloat16", update_defer=4, partial_pricing=2, partial_min_segment=2,
    fallback_shadow=True, refactor_every=32,
)


@pytest.mark.parametrize("backend", BACKENDS)
def test_sharded_flagship_config(pool, jmesh, backend):
    A, b, c = lp(16, 64, 33)
    ref = solve_scipy(A, b, c)
    rec = sharded(pool, 4, A, b, c, SimplexOptions(backend=backend, **FLAGSHIP))
    res = rec["res"]
    jres = jax_solve_sharded(A, b, c, jmesh, options=JaxOptions(**FLAGSHIP))
    assert res.status == ref.status == SolveStatus.OPTIMAL == int(jres.status)
    assert relative_gap(res.z, ref.z) < 1e-5
    assert relative_gap(res.z, jres.z) < 1e-5
    # the segment and shadow rechecks are counted reads, as on one card
    assert rec["reads"]["branch"] > 0


def test_result_contract_unified_across_modes(pool, jmesh):
    # tests/test_dist.py::test_result_contract_unified_across_modes
    m, n = 16, 64
    A, b, c = lp(m, n, 33)
    r_single = single(A, b, c, SimplexOptions())
    j_1d = jax_solve_sharded(A, b, c, jmesh)
    for R in (2, 4):
        r = sharded(pool, R, A, b, c)["res"]
        assert r.status == SolveStatus.OPTIMAL
        assert r.z == pytest.approx(r_single.z, rel=1e-9, abs=1e-9)
        assert r.z == pytest.approx(j_1d.z, rel=1e-9, abs=1e-9)
        assert r.y is not None and r.y.shape == (m,)
        np.testing.assert_allclose(r.y, r_single.y, rtol=1e-4, atol=1e-5)
        assert r.feas_err <= 1e-9
        assert r.x.shape == (n,)


@pytest.mark.parametrize("backend", BACKENDS)
def test_devex_sharded(pool, jmesh, backend):
    # tests/test_devex.py::test_devex_sharded
    A, b, c = lp(32, 96, 70)
    opts = SimplexOptions(pricing="devex", backend=backend)
    rec = sharded(pool, 4, A, b, c, opts)
    res, ref = rec["res"], single(A, b, c, opts)
    jres = jax_solve_sharded(A, b, c, jmesh, options=JaxOptions(pricing="devex"))
    assert res.status == SolveStatus.OPTIMAL == int(jres.status)
    assert relative_gap(res.z, solve_scipy(A, b, c).z) < 1e-5
    assert res.iters == ref.iters == int(jres.iters)
    np.testing.assert_array_equal(res.basis, ref.basis)
    # devex's pick (in each control read) and gamma_p (each pivot step):
    # one reduction each, besides the column
    assert rec["collectives"]["devex_choose"] >= rec["steps"]
    assert rec["collectives"]["gather_cost"] == rec["steps"]


def test_defer_sharded(pool, jmesh):
    # tests/test_deferred_update.py::test_defer_sharded
    A, b, c = lp(12, 32, 3)
    ref = solve_scipy(A, b, c)
    res = sharded(pool, 4, A, b, c, SimplexOptions(update_defer=4, backend="hopper"))["res"]
    jres = jax_solve_sharded(
        A, b, c, jax_make_mesh(axis_names=(COLS_AXIS,), devices=jax.devices()[:4]),
        options=JaxOptions(update_defer=4),
    )
    assert res.status == SolveStatus.OPTIMAL == int(jres.status)
    assert relative_gap(res.z, ref.z) < 1e-4
    assert relative_gap(res.z, jres.z) < 1e-4


def sparse_canonical(m, k, density, seed):
    """``tests/test_sparse_general.py``'s sparse A0 + identity slacks."""
    rng = np.random.default_rng(seed)
    A0 = rng.uniform(0.2, 1.5, (m, k))
    A0[rng.uniform(size=A0.shape) > density] = 0.0
    A = np.hstack([A0, np.eye(m)]).astype(np.float32)
    b = (A0 @ rng.uniform(0.2, 0.8, k) + rng.uniform(0.1, 1.0, m)).astype(np.float32)
    c = np.concatenate([rng.uniform(0.5, 2, k), np.zeros(m)]).astype(np.float32)
    return A, b, c


@pytest.mark.parametrize("pricing", ["dantzig", "devex"])
def test_solve_sharded_sparse(pool, jmesh, pricing):
    # tests/test_sparse_general.py::test_solve_sharded_sparse: dense, a
    # SparseA and scipy CSR give the same answer
    A, b, c = sparse_canonical(16, 48, density=0.3, seed=41)
    opts = SimplexOptions(pricing=pricing, backend="hopper")
    ref = solve_scipy(A, b, c)
    dense = sharded(pool, 4, A, b, c, opts)["res"]
    res = sharded(pool, 4, from_scipy(sps.csc_matrix(A), torch.float32, "cpu"), b, c, opts)["res"]
    res2 = sharded(pool, 3, sps.csr_matrix(A), b, c, opts)["res"]
    jres = jax_solve_sharded(A, b, c, jmesh, options=JaxOptions(pricing=pricing))
    assert dense.status == res.status == res2.status == SolveStatus.OPTIMAL == int(jres.status)
    assert relative_gap(res.z, ref.z) < 1e-5
    assert relative_gap(res.z, dense.z) < 1e-6
    assert relative_gap(res2.z, ref.z) < 1e-5
    assert res.feas_err < 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
def test_uneven_shards(pool, backend):
    # n = 50 over 3 ranks: shards of 17, 17 and 16 columns (the reference
    # asks for padding instead)
    A, b, c = lp(20, 50, 5)
    opts = SimplexOptions(backend=backend)
    res = sharded(pool, 3, A, b, c, opts)["res"]
    ref = single(A, b, c, opts)
    assert res.status == ref.status == SolveStatus.OPTIMAL
    assert res.iters == ref.iters and res.z == ref.z
    np.testing.assert_array_equal(res.basis, ref.basis)
    assert relative_gap(res.z, solve_scipy(A, b, c).z) < 1e-5
    assert list(tsh.shard_bounds(50, 3)) == [0, 17, 34, 50]


def test_bland_choice_across_ranks(pool):
    # Bland's rule after every degenerate pivot: its first-negative key
    # crosses the ranks; the single solve without perturbation (the sharded
    # state has none, as in the reference) walks the same path
    A, b, c = degenerate_streak_lp()
    opts = SimplexOptions(bland_after=1, perturb_after=0, backend="hopper")
    res = sharded(pool, 4, A, b, c, opts)["res"]
    ref = single(A, b, c, opts)
    assert res.status == ref.status == SolveStatus.OPTIMAL
    assert res.iters == ref.iters
    np.testing.assert_array_equal(res.basis, ref.basis)


def test_two_collectives_a_dantzig_pivot(pool):
    A, b, c = lp(32, 96, 22)
    rec = sharded(pool, 4, A, b, c, SimplexOptions(backend="hopper"))
    col = rec["collectives"]
    # every pivot step: one packed MIN and one SUM of the column with its cost
    assert col["choose_entering"] == col["gather_column_cost"] == rec["steps"]
    assert col["devex_choose"] == col["gather_cost"] == 0
    # the start's c_b, each verify round's re-inversion, the polish's columns
    assert col["init"] == 1 and col["basis_columns64"] == 1
    assert col["gather_basis_matrix"] >= 1
    # one control read a pivot step and per loop entry, as on one card
    assert rec["reads"]["branch"] == 0


def test_steepest_raises_and_multi_price_is_inert(pool):
    A, b, c = lp(16, 48, 21)
    errs = pool.run("sharded_error", 2, A, b, c, SimplexOptions(pricing="steepest"))
    assert errs[0][0] == errs[1][0] == "NotImplementedError"
    assert "devex" in errs[0][1]
    got = pool.run("sharded_warns", 2, A, b, c, SimplexOptions(multi_price=8, backend="torch"))[0]
    assert any("multi_price=8 is inert" in w for w in got["warnings"])
    plain = sharded(pool, 2, A, b, c)["res"]
    assert got["res"].iters == plain.iters and got["res"].z == plain.z


def test_refusals(pool):
    A, b, c = lp(4, 10, 1)
    # n below the rank count, and shards that disagree on segmented pricing
    assert pool.run("sharded_error", 4, A[:, :3][:3], b[:3], c[:3], SimplexOptions())[0][0] == "ValueError"
    A, b, c = lp(8, 50, 2)
    err = pool.run("sharded_error", 3, A, b, c, SimplexOptions(partial_pricing=2, partial_min_segment=2))
    assert err[0][0] == "ValueError" and "disagree" in err[0][1]


def test_packed_keys_order_as_the_values():
    vals = torch.tensor([float("nan"), -float("inf"), -3.5, -1e-30, -0.0, 0.0, 1e-30, 2.0, float("inf")])
    keys = tsh._order_bits(vals)
    assert keys[0] < keys[1]  # NaN first, as the kernel's min takes it
    assert torch.all(keys[1:-1] <= keys[2:])
    assert keys[4] == keys[5]  # -0.0 packs as +0.0
    packed = tsh._pack(vals[1:], torch.arange(8))
    want = torch.where(vals[1:] == 0, 0.0, vals[1:])  # -0.0 comes back as +0.0
    np.testing.assert_array_equal(tsh._value(packed).numpy(), want.numpy())
    np.testing.assert_array_equal((packed & 0xFFFFFFFF).numpy(), np.arange(8))
    # equal values: the lower index wins a MIN
    assert tsh._pack(torch.tensor(-1.0), 7) < tsh._pack(torch.tensor(-1.0), 9)


def test_make_mesh_starts_a_group_of_one():
    import torch.distributed as dist

    assert not dist.is_initialized()
    try:
        mesh = tmesh.make_mesh(device="cpu")
        assert dist.get_world_size() == 1 and mesh.size() == 1
        A, b, c = lp(16, 48, 21)
        res = tsh.solve_sharded(A, b, c, mesh, options=SimplexOptions(backend="torch"))
        assert res.z == single(A, b, c, SimplexOptions(backend="torch")).z
    finally:
        dist.destroy_process_group()


def test_initialize_multihost_arguments():
    import torch.distributed as dist

    tmesh.initialize_multihost()  # nothing to join: a no-op
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator_address"):
        tmesh.initialize_multihost("127.0.0.1:1", 2)
