"""The port's 2-D (rows x cols) solve and its checkpointed solve against
the JAX package's.

``simplex_tpu_torch.dist.sharded2d.solve_sharded_2d`` and
``dist.checkpoint2d.solve_sharded_2d_with_checkpoints`` on meshes (R, C) in
{(1, 1), (1, 2), (2, 1), (2, 2)} of gloo CPU ranks (one pool of four for
the module) against ``simplex_tpu.dist.sharded2d`` / ``checkpoint2d`` on
the conftest's 8-device virtual mesh of the same shape, the port's single
``solve`` and HiGHS: the cases of ``tests/test_dist2d.py`` and
``tests/test_checkpoint2d.py`` one for one (the reference's 2 x 4 and 4 x 2
meshes become 2 x 2, which four ranks allow), then uneven shards, sparse
A, the collectives a pivot, a chunk of both packages from one carried
reference state, and light snapshots carried between the packages both
ways. Status, z (1e-5 of HiGHS, as the reference's tests) and feas_err are
compared; pivot counts and bases only on tie-free instances (random dense
LPs under Dantzig's rule). Every rank must return the same result, bit for
bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from simplex_tpu import sparse as jsparse
from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.dist import checkpoint2d as jck
from simplex_tpu.dist.mesh import make_mesh as jax_make_mesh
from simplex_tpu.dist.sharded2d import _build_2d_fn
from simplex_tpu.dist.sharded2d import solve_sharded_2d as jax_solve_2d
from simplex_tpu_torch import SimplexOptions, SolveStatus, solve
from simplex_tpu_torch.dist import checkpoint2d as tck
from simplex_tpu_torch.dist.mesh import COLS_AXIS, ROWS_AXIS
from simplex_tpu_torch.kernels import hopper
from simplex_tpu_torch.oracle.generator import degenerate_streak_lp, random_dense_lp
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy
from torch_dist_ranks import RankPool

OPT = SolveStatus.OPTIMAL
MESHES = [(1, 1), (1, 2), (2, 1), (2, 2)]


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def jmesh(R, C):
    assert len(jax.devices()) == 8
    return jax_make_mesh(axis_names=(ROWS_AXIS, COLS_AXIS), shape=(R, C), devices=jax.devices()[: R * C])


def lp(m, n, seed):
    return random_dense_lp(m, n, seed=seed, dtype=np.float32)


def same_on_every_rank(out):
    r0 = out[0]["res"]
    for rec in out[1:]:
        r = rec["res"]
        assert (r.status, r.iters, r.z, r.feas_err) == (r0.status, r0.iters, r0.z, r0.feas_err)
        for f in ("basis", "x", "x_b", "y"):
            np.testing.assert_array_equal(getattr(r, f), getattr(r0, f))


def run2d(pool, R, C, A, b, c, basis0=None, **kw):
    """The 2-D solve on an R x C mesh (plain ops unless ``backend`` is
    given); rank 0's record."""
    kw.setdefault("backend", "torch")
    out = pool.run("sharded2d", R, C, A, b, c, SimplexOptions(**kw), basis0)[: R * C]
    same_on_every_rank(out)
    return out[0]


def jax_opts(kw):
    kw = {k: v for k, v in kw.items() if k != "backend"}
    if kw.get("dtype") is torch.float64:
        kw["dtype"] = jnp.float64
    return JaxOptions(**kw)


def oracle_ok(res, A, b, c, gap=1e-5):
    ref = solve_scipy(A, b, c)
    assert res.status == ref.status == OPT
    assert relative_gap(res.z, ref.z) < gap
    np.testing.assert_allclose(A @ res.x, b, atol=1e-3)


# --------------------------------------------------------------------------
# tests/test_dist2d.py, one for one
# --------------------------------------------------------------------------


@pytest.mark.parametrize("R,C", MESHES)
def test_2d_matches_oracle(pool, R, C):
    m, n = 8 * max(R, 2), 16 * max(R, 2) * C
    A, b, c = lp(m, n, 3)
    rec = run2d(pool, R, C, A, b, c)
    res = rec["res"]
    oracle_ok(res, A, b, c)
    jres = jax_solve_2d(A, b, c, jmesh(R, C))
    # a tie-free instance: the reference's pivots and basis
    assert res.iters == int(jres.iters) and int(jres.status) == OPT
    np.testing.assert_array_equal(np.sort(res.basis), np.sort(np.asarray(jres.basis)))
    assert res.z == pytest.approx(float(jres.z), rel=1e-9)
    assert res.feas_err <= 1e-9 and float(jres.feas_err) <= 1e-9


def test_2d_matches_1d_and_single(pool):
    A, b, c = lp(16, 64, 5)
    single = solve(A, b, c, device="cpu")
    one_d = pool.run("sharded", 4, A, b, c, SimplexOptions(backend="torch"))[0]["res"]
    two_d = run2d(pool, 2, 2, A, b, c)["res"]
    assert single.status == one_d.status == two_d.status == OPT
    assert two_d.z == pytest.approx(single.z, rel=1e-5)
    assert one_d.z == pytest.approx(single.z, rel=1e-5)
    assert two_d.z == pytest.approx(float(jax_solve_2d(A, b, c, jmesh(2, 2)).z), rel=1e-9)


@pytest.mark.parametrize("R,C", [(2, 2), (1, 2)])
def test_2d_bf16_pricing(pool, R, C):
    A, b, c = lp(16, 32, 7)
    kw = dict(pricing_dtype="bfloat16")
    res = run2d(pool, R, C, A, b, c, **kw)["res"]
    oracle_ok(res, A, b, c)
    jres = jax_solve_2d(A, b, c, jmesh(R, C), options=jax_opts(kw))
    assert int(jres.status) == OPT and res.z == pytest.approx(float(jres.z), rel=1e-5)


@pytest.mark.parametrize("R,C", [(2, 2), (2, 1)])
def test_2d_unbounded(pool, R, C):
    # max x0 with one <=-row whose slack can grow: unbounded decided globally
    m, n = 2, 8
    A = np.zeros((m, n), np.float32)
    A[0, 0] = -1.0
    A[1, 1] = 1.0
    A[:, n - m :] = np.eye(m, dtype=np.float32)
    b = np.array([1.0, 2.0], np.float32)
    c = np.zeros(n, np.float32)
    c[0] = 1.0
    res = run2d(pool, R, C, A, b, c)["res"]
    assert res.status == SolveStatus.UNBOUNDED == int(jax_solve_2d(A, b, c, jmesh(R, C)).status)


def test_2d_shape_validation(pool):
    A, b, c = lp(5, 24, 1)
    kind, text = pool.run("sharded2d_error", 2, 2, A, b, c, SimplexOptions(backend="torch"))[0]
    assert kind == "ValueError" and "divide the mesh" in text  # m = 5 over R = 2
    with pytest.raises(ValueError, match="divide the mesh"):
        jax_solve_2d(A, b, c, jmesh(2, 2))
    A, b, c = lp(2, 3, 1)
    kind, text = pool.run("sharded2d_error", 2, 2, A, b, c, SimplexOptions(backend="torch"))[0]
    assert kind == "ValueError" and "divide the mesh" in text  # 3 columns over 4 ranks
    A, b, c = lp(8, 32, 1)
    kind, text = pool.run("sharded2d_error", 2, 2, A, b, c, SimplexOptions(backend="torch", pricing="steepest"))[0]
    assert kind == "NotImplementedError" and "steepest" in text


def test_2d_with_refactorization(pool):
    A, b, c = lp(16, 64, 9)
    kw = dict(refactor_every=4, pricing_dtype="bfloat16")
    rec = run2d(pool, 2, 2, A, b, c, **kw)
    oracle_ok(rec["res"], A, b, c)
    assert rec["collectives"]["refactor"] > 0
    jres = jax_solve_2d(A, b, c, jmesh(2, 2), options=jax_opts(kw))
    assert rec["res"].z == pytest.approx(float(jres.z), rel=1e-5)


def test_2d_refactorization_rescues_corrupt_inverse(pool):
    # f64 with a re-inversion every 2 pivots: the single solve's objective
    A, b, c = random_dense_lp(8, 32, seed=14, dtype=np.float64)
    kw = dict(dtype=torch.float64, backend="torch")
    single = solve(A, b, c, options=SimplexOptions(**kw), device="cpu")
    res = run2d(pool, 2, 2, A, b, c, refactor_every=2, **kw)["res"]
    assert res.status == OPT
    assert res.z == pytest.approx(single.z, rel=1e-9)
    jres = jax_solve_2d(A, b, c, jmesh(2, 2), options=jax_opts(dict(refactor_every=2, **kw)))
    assert res.z == pytest.approx(float(jres.z), rel=1e-9)


@pytest.mark.parametrize("R,C", [(2, 2), (2, 1)])
def test_2d_nonzero_slack_costs(pool, R, C):
    # each slot's cost comes from its column's owner, in another rows group
    rng = np.random.default_rng(0)
    m, n = 8, 32
    A = np.zeros((m, n), np.float32)
    A[:, : n - m] = rng.uniform(0.2, 1.0, (m, n - m)).astype(np.float32)
    A[:, n - m :] = np.eye(m, dtype=np.float32)
    b = rng.uniform(1.0, 2.0, m).astype(np.float32)
    c = rng.standard_normal(n).astype(np.float32)
    c[n - m :] = rng.uniform(-1.0, -0.1, m)
    res = run2d(pool, R, C, A, b, c)["res"]
    oracle_ok(res, A, b, c)
    assert res.z == pytest.approx(float(jax_solve_2d(A, b, c, jmesh(R, C)).z), rel=1e-9)


@pytest.mark.parametrize("L", [4, 16])
def test_2d_update_defer(pool, L):
    A, b, c = lp(16, 64, 11)
    res = run2d(pool, 2, 2, A, b, c, update_defer=L)["res"]
    oracle_ok(res, A, b, c)
    jres = jax_solve_2d(A, b, c, jmesh(2, 2), options=jax_opts(dict(update_defer=L)))
    assert res.iters == int(jres.iters)
    assert res.z == pytest.approx(float(jres.z), rel=1e-9)


def test_2d_partial_pricing(pool):
    A, b, c = lp(16, 64, 12)
    kw = dict(partial_pricing=2, partial_min_segment=4)
    rec = run2d(pool, 2, 2, A, b, c, **kw)
    oracle_ok(rec["res"], A, b, c)
    # segments priced (one recheck read a pivot), the exact pass on a miss
    assert rec["reads"]["branch"] >= rec["res"].iters
    jres = jax_solve_2d(A, b, c, jmesh(2, 2), options=jax_opts(kw))
    assert rec["res"].iters == int(jres.iters)


@pytest.mark.parametrize("R,C", [(2, 2), (1, 2)])
def test_2d_devex(pool, R, C):
    A, b, c = lp(16, 64, 13)
    rec = run2d(pool, R, C, A, b, c, pricing="devex")
    oracle_ok(rec["res"], A, b, c)
    jres = jax_solve_2d(A, b, c, jmesh(R, C), options=jax_opts(dict(pricing="devex")))
    assert int(jres.status) == OPT and rec["res"].z == pytest.approx(float(jres.z), rel=1e-5)
    # the pick's MIN each control read, gamma_p's SUM each pivot step
    assert rec["collectives"]["devex_choose"] >= rec["steps"]
    assert rec["collectives"]["gather_cost"] == rec["steps"]


def test_2d_flagship_config(pool):
    A, b, c = lp(16, 64, 15)
    kw = dict(pricing_dtype="bfloat16", update_defer=8, partial_pricing=2, partial_min_segment=4,
              refactor_every=32)
    res = run2d(pool, 2, 2, A, b, c, **kw)["res"]
    oracle_ok(res, A, b, c)
    assert res.z == pytest.approx(float(jax_solve_2d(A, b, c, jmesh(2, 2), options=jax_opts(kw)).z), rel=1e-5)


def test_2d_devex_with_defer_and_refactor(pool):
    A, b, c = lp(16, 32, 16)
    kw = dict(pricing="devex", update_defer=4, refactor_every=16)
    res = run2d(pool, 2, 2, A, b, c, **kw)["res"]
    oracle_ok(res, A, b, c)
    assert res.z == pytest.approx(float(jax_solve_2d(A, b, c, jmesh(2, 2), options=jax_opts(kw)).z), rel=1e-5)


@pytest.mark.parametrize("K", [2, 8])
def test_2d_multi_price_matches_oracle(pool, K):
    A, b, c = lp(16, 64, 21)
    kw = dict(multi_price=K, refactor_every=32)
    rec = run2d(pool, 2, 2, A, b, c, **kw)
    oracle_ok(rec["res"], A, b, c)
    col = rec["collectives"]
    # refills: one SUM of keys and one of K columns each; no pricing MIN
    assert col["refill_topk"] == col["refill_columns"] > 0 and col["choose_entering"] == 0
    jres = jax_solve_2d(A, b, c, jmesh(2, 2), options=jax_opts(kw))
    assert rec["res"].z == pytest.approx(float(jres.z), rel=1e-5)


def test_2d_multi_price_flagship_composition(pool):
    A, b, c = lp(16, 64, 22)
    kw = dict(multi_price=8, pricing_dtype="bfloat16", update_defer=8, refactor_every=32)
    res = run2d(pool, 2, 2, A, b, c, **kw)["res"]
    oracle_ok(res, A, b, c)


def test_2d_multi_price_matches_plain_objective(pool):
    # every 4th rhs zero: Bland's refill and the exact entry recheck
    A, b, c = degenerate_streak_lp(16, 48, seed=7)
    kw = dict(multi_price=4, refactor_every=16, perturb_after=0)
    res = run2d(pool, 2, 2, A, b, c, **kw)["res"]
    ref = solve_scipy(A, b, c)
    assert res.status == OPT and relative_gap(res.z, ref.z) < 1e-4
    plain = run2d(pool, 2, 2, A, b, c, refactor_every=16, perturb_after=0)["res"]
    assert relative_gap(res.z, plain.z) < 1e-4
    jres = jax_solve_2d(A, b, c, jmesh(2, 2), options=jax_opts(kw))
    assert relative_gap(res.z, float(jres.z)) < 1e-4


# --------------------------------------------------------------------------
# the port's own: kernels, collectives, uneven shards, sparse A, options
# --------------------------------------------------------------------------


def test_2d_hopper_backend_on_cpu_tensors(pool):
    # the kernel wrappers (pricing_scan on the shard, rank1_update on the row
    # block) take their plain versions on CPU tensors: the same answer
    A, b, c = lp(16, 64, 3)
    fast = run2d(pool, 2, 2, A, b, c, backend="hopper")
    plain = run2d(pool, 2, 2, A, b, c)
    assert fast["res"].iters == plain["res"].iters and fast["res"].z == plain["res"].z
    np.testing.assert_array_equal(fast["res"].basis, plain["res"].basis)


def test_rank1_update_on_a_row_block():
    g = torch.Generator().manual_seed(0)
    m = 12
    B = torch.randn(m, m, generator=g)
    eta, row = torch.randn(m, generator=g), torch.randn(m, generator=g)
    for lo, hi in ((0, 6), (6, 12), (3, 6)):
        block = B[lo:hi].clone()
        hopper.rank1_update(block, eta[lo:hi].clone(), row)
        np.testing.assert_allclose(block.numpy(), (B + torch.outer(eta, row))[lo:hi].numpy(), rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError, match="block of rows"):
        hopper.rank1_update(torch.zeros(13, 12), torch.zeros(13), row)


def test_2d_collectives_a_pivot(pool):
    A, b, c = lp(16, 64, 3)
    rec = run2d(pool, 2, 2, A, b, c)
    col, k = rec["collectives"], rec["steps"]
    # a Dantzig step: the basis SUM, the pricing MIN, the column SUM, two
    # ratio MINs and the pivot row's SUM
    assert col["choose_entering"] == col["gather_column_cost"] == col["pivot_row"] == k
    assert col["ratio_rows"] == 2 * k
    assert col["basis_rows"] >= k
    # exact pricing: one control read a step, no recheck reads
    assert rec["reads"]["branch"] == 0 and rec["reads"]["control"] >= k


@pytest.mark.parametrize("R,C", [(2, 2), (1, 2)])
def test_2d_uneven_shards(pool, R, C):
    # 50 columns over 4 or 2 ranks (the reference asks for n divisible)
    A, b, c = lp(8, 50, 6)
    if R * C == 4:
        with pytest.raises(ValueError):
            jax_solve_2d(A, b, c, jmesh(R, C))
    res = run2d(pool, R, C, A, b, c)["res"]
    oracle_ok(res, A, b, c)
    single = solve(A, b, c, device="cpu")
    assert res.iters == single.iters and res.z == pytest.approx(single.z, rel=1e-9)


@pytest.mark.parametrize("R,C", [(2, 2), (1, 2)])
def test_2d_sparse(pool, R, C):
    A, b, c = lp(16, 64, 3)
    kw = dict(update_defer=4, partial_pricing=2, partial_min_segment=4)  # segments off on sparse A
    res = run2d(pool, R, C, sps.csc_matrix(A), b, c, **kw)["res"]
    oracle_ok(res, A, b, c)
    jres = jax_solve_2d(jsparse.from_dense(A, block_shape=(8, 8)), b, c, jmesh(R, C), options=jax_opts(kw))
    assert int(jres.status) == OPT and res.z == pytest.approx(float(jres.z), rel=1e-5)


@pytest.mark.parametrize("mode", ["1-D", "2-D", "pdhg"])
def test_sparse_tensor_input(pool, mode):
    # a sparse torch tensor, which the single solve takes, in every sharded
    # mode (each rank's columns came from scipy's tocsc, which a tensor
    # lacks: AttributeError before)
    A, b, c = lp(8, 24, 0)
    At = torch.as_tensor(A).to_sparse_csr()
    if mode == "1-D":
        got, want = (pool.run("sharded", 2, M, b, c, SimplexOptions(backend="torch"))[0]["res"] for M in (At, A))
    elif mode == "2-D":
        got, want = (run2d(pool, 2, 2, M, b, c)["res"] for M in (At, A))
    else:
        got, want = (pool.run("pdhg_sharded", 2, M, b, c, dict(tol=1e-5))[0]["res"] for M in (At, A))
    assert got.status == want.status == OPT
    assert got.z == pytest.approx(want.z, rel=1e-6)


def test_2d_multi_price_under_devex_is_inert(pool):
    A, b, c = lp(16, 64, 13)
    res = run2d(pool, 2, 2, A, b, c, pricing="devex", multi_price=8)
    plain = run2d(pool, 2, 2, A, b, c, pricing="devex")
    assert res["res"].z == plain["res"].z and res["res"].iters == plain["res"].iters
    assert res["collectives"]["refill_topk"] == 0


# --------------------------------------------------------------------------
# a chunk of both packages from one carried reference state
# --------------------------------------------------------------------------


def jax_state(A, b, c, R, C, kw, max_iter, state=None):
    """The reference's 2-D chunk on an R x C virtual mesh: a fresh start, or
    the continuation of ``state``; the global state as numpy arrays."""
    m, n = A.shape
    opts = dataclasses.replace(jax_opts(kw), max_iter=0, checkpoint_every=0)
    mesh = jmesh(R, C)
    if state is None:
        fn = _build_2d_fn(mesh, m, n, m // R, n // (R * C), opts, "start")
        out, _ = fn(A, b, c, jnp.arange(n - m, n, dtype=jnp.int32), jnp.int32(max_iter))
    else:
        fn = _build_2d_fn(mesh, m, n, m // R, n // (R * C), opts, "cont")
        out, _ = fn(A, b, c, {k: jnp.asarray(v) for k, v in state.items()}, jnp.int32(max_iter))
    return {k: np.asarray(v) for k, v in jax.device_get(out).items()}


def whole_state(parts):
    """The global state from the ranks' shards (rows, then columns)."""
    out = {}
    for k in parts[0]["state"]:
        if k in ("B_inv", "x_b", "c_b", "basis", "calpha", "U", "e", "gamma"):
            axis = 1 if k == "U" else 0
            cut = "cols" if k in ("e", "gamma") else "rows"
            seen, pieces = set(), []
            for p in sorted(parts, key=lambda p: p[cut]):
                if p[cut] not in seen:
                    seen.add(p[cut])
                    pieces.append(p["state"][k])
            out[k] = np.concatenate(pieces, axis=axis)
        else:
            out[k] = parts[0]["state"][k]
    return out


@pytest.mark.parametrize("case", ["default", "defer and multi-price", "devex"])
def test_chunk_from_a_carried_jax_state(pool, case):
    kw = {"default": {}, "defer and multi-price": dict(update_defer=4, multi_price=4),
          "devex": dict(pricing="devex")}[case]
    A, b, c = lp(16, 64, 31)
    R, C = 2, 2
    mid = jax_state(A, b, c, R, C, kw, 5)
    assert int(mid["iters"]) == 5
    mid["status"] = np.int32(SolveStatus.RUNNING)
    want = jax_state(A, b, c, R, C, kw, 10_000, mid)
    parts = pool.run("sharded2d_chunk", R, C, A, b, c, SimplexOptions(backend="torch", **kw), mid, 10_000)
    got = whole_state(parts)
    assert int(got["status"]) == int(want["status"]) == OPT
    assert int(got["iters"]) == int(want["iters"])
    np.testing.assert_array_equal(got["basis"], want["basis"])
    np.testing.assert_allclose(got["x_b"], want["x_b"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got["y"], want["y"], rtol=1e-4, atol=1e-5)


# --------------------------------------------------------------------------
# tests/test_checkpoint2d.py, one for one, and snapshots across packages
# --------------------------------------------------------------------------


def checkpointed(pool, R, C, A, b, c, path, fail_at=None, **kw):
    kw.setdefault("backend", "torch")
    out = pool.run("checkpointed2d", R, C, A, b, c, SimplexOptions(**kw), str(path), True, fail_at)[: R * C]
    if "res" in out[0]:
        same_on_every_rank(out)
    return out[0]


def test_chunked_matches_direct(pool, tmp_path):
    A, b, c = lp(16, 64, 41)
    direct = run2d(pool, 2, 2, A, b, c)["res"]
    rec = checkpointed(pool, 2, 2, A, b, c, tmp_path / "c2d.npz", checkpoint_every=8)
    res = rec["res"]
    oracle_ok(res, A, b, c)
    assert res.z == pytest.approx(direct.z, rel=1e-9, abs=1e-9)
    assert len(rec["chunks"]) >= 2
    assert res.feas_err <= 1e-9 and res.y is not None


def test_resume_from_mid_solve_snapshot(pool, tmp_path):
    A, b, c = lp(16, 64, 43)
    path = tmp_path / "c2d.npz"
    part = checkpointed(pool, 2, 2, A, b, c, path, checkpoint_every=4, max_iter=8)["res"]
    assert part.status == SolveStatus.MAX_ITER
    basis, iters, degen = tck.load_light_snapshot(path, 16, 64)
    assert iters == 8
    res = checkpointed(pool, 2, 2, A, b, c, path, checkpoint_every=4)["res"]
    oracle_ok(res, A, b, c)
    assert res.iters > 8  # continued, not restarted


def test_failed_chunk_keeps_its_snapshot_and_resumes(pool, tmp_path):
    # the counterpart of the reference's elastic test: no retry loop; the
    # failed call raises on every rank, the next call resumes from the last
    # snapshot and rebuilds the inverse on the mesh
    A, b, c = lp(16, 64, 47)
    path = tmp_path / "c2d.npz"
    failed = checkpointed(pool, 2, 2, A, b, c, path, fail_at=2, checkpoint_every=4)
    assert "injected" in failed["error"] and failed["chunks"] == [4]
    assert tck.load_light_snapshot(path, 16, 64)[1] == 4
    res = checkpointed(pool, 2, 2, A, b, c, path, checkpoint_every=4)["res"]
    oracle_ok(res, A, b, c)


def test_error_in_the_first_chunk_propagates(pool, tmp_path):
    A, b, c = lp(8, 32, 48)
    path = tmp_path / "c2d.npz"
    failed = checkpointed(pool, 2, 2, A, b, c, path, fail_at=1, checkpoint_every=8)
    assert "injected" in failed["error"] and failed["chunks"] == []
    assert not path.exists()


def test_chunked_flagship_config(pool, tmp_path):
    A, b, c = lp(16, 64, 53)
    rec = checkpointed(pool, 2, 2, A, b, c, tmp_path / "c2d.npz", checkpoint_every=8, pricing="devex",
                       update_defer=4, pricing_dtype="bfloat16", refactor_every=16)
    oracle_ok(rec["res"], A, b, c)


def test_snapshot_validation_rejects_corrupt(tmp_path):
    m, n = 8, 32
    path = tmp_path / "c2d.npz"
    bad = np.arange(m, dtype=np.int32)
    bad[0] = n + 5
    tck.save_light_snapshot(path, bad, 3, 0, 0)
    with pytest.raises(ValueError, match="out of range"):
        tck.load_light_snapshot(path, m, n)
    tck.save_light_snapshot(path, np.zeros(m, dtype=np.int32), 3, 0, 0)
    with pytest.raises(ValueError, match="duplicate"):
        tck.load_light_snapshot(path, m, n)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_snapshots_cross_packages(pool, tmp_path, writer):
    A, b, c = lp(16, 64, 43)
    path = tmp_path / "c2d.npz"
    if writer == "jax":
        part = jck.solve_sharded_2d_with_checkpoints(
            A, b, c, jmesh(2, 2), path=path, options=JaxOptions(checkpoint_every=4, max_iter=8))
        assert int(part.status) == SolveStatus.MAX_ITER
        res = checkpointed(pool, 2, 2, A, b, c, path, checkpoint_every=4)["res"]
    else:
        part = checkpointed(pool, 2, 2, A, b, c, path, checkpoint_every=4, max_iter=8)["res"]
        assert part.status == SolveStatus.MAX_ITER
        res = jck.solve_sharded_2d_with_checkpoints(
            A, b, c, jmesh(2, 2), path=path, options=JaxOptions(checkpoint_every=4))
    assert int(res.status) == OPT and res.iters > 8
    assert relative_gap(float(res.z), solve_scipy(A, b, c).z) < 1e-5


# --------------------------------------------------------------------------
# the four-card check and the dryrun, rehearsed on gloo CPU ranks
# --------------------------------------------------------------------------


def test_card_check_2d_rehearses_on_cpu_ranks(tmp_path):
    # --mode 2d's flow on a 2 x 2 mesh at a tiny size: every rank the same
    # window, equal to the single solve's, six collectives a Dantzig step
    import json

    from simplex_tpu_torch.dist import card_check

    out = tmp_path / "cc2d.json"
    rc = card_check.main(["--device", "cpu", "--mode", "2d", "--rows", "2", "--ranks", "4", "--m", "24",
                          "--n", "80", "--window", "16", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rc == 0 and rec["two_d_ranks_agree"] and rec["two_d_matches_single_card"]
    assert rec["two_d_pivots"] == 16 and rec["mesh"] == [2, 2]
    per = rec["two_d_collectives_per_step"]
    assert per["choose_entering"] == per["gather_column_cost"] == per["pivot_row"] == 1.0
    assert per["ratio_rows"] == 2.0


def test_dryrun_runs_every_mode_on_cpu_ranks(capsys):
    from simplex_tpu_torch.dist import dryrun

    assert dryrun.main(["--ranks", "2", "--device", "cpu"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("dryrun_multichip(2): 1d z=")
    for mode in ("batched ok", "warm-serving ok", "2d flagship", "2d chunk-resume", "sharded pdhg"):
        assert mode in line


@pytest.mark.parametrize("device,ranks,cards,backend", [
    ("cpu", 4, 4, "gloo"), ("cuda", 4, 4, "nccl"), ("cuda", 2, 4, "nccl"), ("cuda", 4, 1, "gloo"),
])
def test_dryrun_transport(monkeypatch, device, ranks, cards, backend):
    # NCCL when every rank has a card of its own; ranks that share a card
    # (NCCL refuses one twice) and CPU ranks join over gloo
    from simplex_tpu_torch.dist import dryrun

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert dryrun.transport(device, ranks) == backend
