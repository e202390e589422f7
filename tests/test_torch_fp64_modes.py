"""Float64 in the port's batched and sharded modes under the default backend.

``SimplexOptions(dtype=torch.float64)`` runs ``solve_batched`` /
``reoptimize_batched`` (with and without a mesh), ``solve_sharded`` and
``solve_sharded_2d`` through the kernels' float64 instantiations (on the
CPU the hopper wrappers take their plain versions) and carries the sharded
modes' MIN keys in float64 (``dist.sharded.key_codec``). Held against the
JAX package in float64 (``simplex_tpu.batch.vmapped`` under its ``xla``
backend and, at a Pallas-eligible shape, ``pallas`` in interpret mode;
``simplex_tpu.dist`` on the conftest's virtual mesh), the port's single
float64 ``solve`` and HiGHS: statuses equal, z within a relative 1e-9.

The 2-D solve once rounded theta's minimum to float32 on its way through
the MIN over "rows": ``theta == tmin`` then matched no row and the walk
left the feasible region (``random_dense_lp(16, 40, seed=3)`` under the
classic test ended "OPTIMAL" at z 2.3632 against HiGHS's 1.8586); the 1-D
pricing MIN tied two reduced costs that differ below float32's resolution
to the lower column, where the reference's ``pmin`` in float64 picks the
true minimum. One pool of four gloo CPU ranks serves the module.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sps
import torch

from simplex_tpu import solve as jax_solve
from simplex_tpu.batch.vmapped import reoptimize_batched as jax_reoptimize_batched
from simplex_tpu.batch.vmapped import solve_batched as jax_solve_batched
from simplex_tpu.config import SimplexOptions as JaxOptions
from simplex_tpu.dist.mesh import make_mesh as jax_make_mesh
from simplex_tpu.dist.sharded import solve_sharded as jax_solve_sharded
from simplex_tpu.dist.sharded2d import solve_sharded_2d as jax_solve_2d
from simplex_tpu_torch import SimplexOptions, SolveStatus, reoptimize_batched, solve, solve_batched
from simplex_tpu_torch.dist import sharded as tsh
from simplex_tpu_torch.dist.mesh import COLS_AXIS, ROWS_AXIS
from simplex_tpu_torch.kernels import hopper, ops
from simplex_tpu_torch.oracle.generator import degenerate_streak_lp, random_dense_lp
from simplex_tpu_torch.oracle.reference import relative_gap, solve_scipy
from torch_dist_ranks import RankPool

OPT = SolveStatus.OPTIMAL
GAP = 1e-9  # the JAX suite's float64 gate (tests/test_dist2d.py:116)
BACKENDS = ["hopper", "torch"]
F64 = torch.float64


@pytest.fixture(scope="module")
def pool():
    p = RankPool(4)
    yield p
    p.close()


def f64(*arrays):
    return tuple(np.asarray(a, np.float64) for a in arrays)


def jmesh(*shape):
    """The conftest's virtual devices as a JAX mesh: ("cols",) of R, or
    ("rows", "cols") of (R, C)."""
    names = (COLS_AXIS,) if len(shape) == 1 else (ROWS_AXIS, COLS_AXIS)
    return jax_make_mesh(axis_names=names, shape=shape, devices=jax.devices()[: int(np.prod(shape))])


def same_on_every_rank(out):
    r0 = out[0]["res"]
    for rec in out[1:]:
        r = rec["res"]
        assert (r.status, r.iters, r.z, r.feas_err) == (r0.status, r0.iters, r0.z, r0.feas_err)
        for f in ("basis", "x", "x_b", "y"):
            np.testing.assert_array_equal(getattr(r, f), getattr(r0, f))
    return r0


# ---- the 2-D solve's ratio test in float64 (the fault) ----------------------

FAULTS = {
    # the instance that ended "OPTIMAL" at z 2.3632 (HiGHS 1.8586) before
    "classic, seed 3": (lambda: random_dense_lp(16, 40, seed=3, dtype=np.float64), {"ratio": "classic"}),
    "classic, seed 14": (lambda: random_dense_lp(16, 40, seed=14, dtype=np.float64), {"ratio": "classic"}),
    # Harris with Bland's rule from the first degenerate pivot (tie = theta == tmin)
    "harris, bland_after=1": (lambda: f64(*degenerate_streak_lp(24, 60, seed=5)), {"bland_after": 1}),
}


@functools.lru_cache(maxsize=None)
def jax_2d(case, mesh):
    make, kw = FAULTS[case]
    return jax_solve_2d(*make(), jmesh(*mesh), options=JaxOptions(dtype=jnp.float64, **kw))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("mesh", [(1, 1), (2, 2)])
@pytest.mark.parametrize("case", list(FAULTS))
def test_2d_ratio_test_keeps_float64(pool, case, mesh, backend):
    make, kw = FAULTS[case]
    A, b, c = make()
    opts = SimplexOptions(dtype=F64, backend=backend, **kw)
    R, C = mesh
    res = same_on_every_rank(pool.run("sharded2d", R, C, A, b, c, opts)[: R * C])
    ref, one, jres = solve_scipy(A, b, c), solve(A, b, c, options=opts, device="cpu"), jax_2d(case, mesh)
    assert res.status == one.status == jres.status == OPT
    assert relative_gap(res.z, ref.z) <= GAP and relative_gap(res.z, one.z) <= GAP
    assert relative_gap(res.z, float(jres.z)) <= GAP
    assert res.feas_err <= GAP


@pytest.mark.parametrize("backend", BACKENDS)
def test_2d_refactor_every_2_f64(pool, backend):
    """``tests/test_dist2d.py::test_2d_refactorization_rescues_corrupt_inverse``
    (2 x 2, ``refactor_every=2``) on the port: z within 1e-9 of JAX's 2-D
    and single solves and of the port's single solve."""
    A, b, c = random_dense_lp(8, 32, seed=14, dtype=np.float64)
    opts = SimplexOptions(dtype=F64, backend=backend, refactor_every=2)
    res = same_on_every_rank(pool.run("sharded2d", 2, 2, A, b, c, opts))
    jopts = JaxOptions(dtype=jnp.float64, refactor_every=2)
    jres = jax_solve_2d(A, b, c, jmesh(2, 2), options=jopts)
    jone = jax_solve(A, b, c, options=JaxOptions(dtype=jnp.float64))
    assert res.status == OPT
    for z in (float(jres.z), float(jone.z), solve(A, b, c, options=opts, device="cpu").z):
        assert relative_gap(res.z, z) <= GAP


# ---- the 1-D pricing MIN in float64 -----------------------------------------


def near_tie_lp():
    """4 x 12 ([G | I]) whose slack start prices columns 1 (rank 0 of two)
    and 6 (rank 1) at -1 and -(1 + 2e-10): one float32 value, two float64
    ones; the minimum is on the higher column."""
    rng = np.random.default_rng(41)
    m, k = 4, 8
    A = np.hstack([rng.uniform(0.2, 1.0, (m, k)), np.eye(m)])
    b = rng.uniform(1.0, 2.0, m)
    c = np.concatenate([rng.uniform(0.1, 0.5, k), np.zeros(m)])
    c[1], c[6] = 1.0, 1.0 + 2e-10
    return A, b, c


@pytest.mark.parametrize("backend", BACKENDS)
def test_1d_pick_between_near_ties_on_two_ranks(pool, backend):
    A, b, c = near_tie_lp()
    assert np.float32(c[1]) == np.float32(c[6]) and c[6] > c[1]
    opts = SimplexOptions(dtype=F64, backend=backend, max_iter=1)
    out = pool.run("sharded", 2, A, b, c, opts)[:2]
    res = out[0]["res"]
    np.testing.assert_array_equal(out[1]["res"].basis, res.basis)
    one = solve(A, b, c, options=opts, device="cpu")
    jres = jax_solve_sharded(A, b, c, jmesh(2), options=JaxOptions(dtype=jnp.float64, max_iter=1))
    assert 6 in res.basis and 1 not in res.basis
    np.testing.assert_array_equal(res.basis, one.basis)
    np.testing.assert_array_equal(res.basis, np.asarray(jres.basis))
    # the whole solve: two collectives a Dantzig pivot step, as in float32
    full = pool.run("sharded", 2, A, b, c, SimplexOptions(dtype=F64, backend=backend))[0]
    col, k = full["collectives"], full["steps"]
    assert full["res"].status == OPT and relative_gap(full["res"].z, solve_scipy(A, b, c).z) <= GAP
    assert col["choose_entering"] == col["gather_column_cost"] == k


def test_pair_keys_order_as_float64_values():
    """The float64 keys: all 64 bits of the value (-0.0 as +0.0, NaN
    first), then the index; their MIN and their k smallest in that order."""
    kc = tsh.key_codec(F64)
    vals = torch.tensor([float("nan"), -float("inf"), -1.0 - 2e-10, -1.0, -1e-300, -0.0, 0.0, 5e-324, 2.0,
                         float("inf")], dtype=F64)
    keys = kc.pack(vals, torch.arange(10))
    assert keys.shape == (10, 2)
    assert torch.all(keys[:-1, 0] <= keys[1:, 0]) and keys[0, 0] < keys[1, 0] and keys[5, 0] == keys[6, 0]
    back = kc.value(keys[1:])
    np.testing.assert_array_equal(back.numpy(), torch.where(vals[1:] == 0, 0.0, vals[1:]).numpy())
    assert tsh.key_codec(torch.float32).pack(vals[2:3], 0) == tsh.key_codec(torch.float32).pack(vals[3:4], 0)
    # equal values: the lower index first
    tie = kc.pack(torch.tensor([-1.0, -1.0, -3.0], dtype=F64), torch.tensor([9, 4, 7]))
    np.testing.assert_array_equal(kc.smallest(tie, 3)[:, 1].numpy(), [7, 4, 9])
    np.testing.assert_array_equal(tsh._lex_min(tie[:2].unsqueeze(1))[0].numpy(), tie[1].numpy())



@pytest.mark.parametrize("dtype", [torch.float32, F64])
def test_local_columns_upload_in_row_blocks(monkeypatch, dtype):
    """A dense numpy shard is copied in blocks of rows, each converted to
    the working dtype as it is copied: the same values as one conversion of
    the whole slice, at any block size."""
    A = np.random.default_rng(0).standard_normal((7, 10)).astype(np.float32)
    want = torch.from_numpy(A[:, 2:9]).to(dtype)
    for nbytes in (1, 60, 1 << 28):  # a row a block, 2 rows, the whole shard
        monkeypatch.setattr(tsh, "_UPLOAD_BYTES", nbytes)
        got = tsh._local_columns(A, 2, 9, dtype, "cpu")
        assert got.dtype == dtype and got.is_contiguous()
        torch.testing.assert_close(got, want, rtol=0, atol=0)


# ---- the batched modes in float64 --------------------------------------------

BATCH_SETS = {
    "dantzig": {},
    "devex": dict(pricing="devex"),
    "steepest": dict(pricing="steepest"),
    "8 segments": dict(partial_pricing=8, partial_min_segment=4),
    "bf16 shadow": dict(pricing_dtype="bfloat16"),
}


def batch_stack(B=4, m=12, n=32, seed0=100):
    lps = [random_dense_lp(m, n, seed=seed0 + s, dtype=np.float64) for s in range(B)]
    return [np.stack([lp[k] for lp in lps]) for k in range(3)]


@functools.lru_cache(maxsize=None)
def jax_batched(name, backend="xla", shape=(4, 12, 32)):
    return jax_solve_batched(*batch_stack(*shape), options=JaxOptions(dtype=jnp.float64, backend=backend,
                                                                      **BATCH_SETS[name]))


def same_batch(res, jres, stack=None):
    np.testing.assert_array_equal(res.status, np.asarray(jres.status))
    assert res.z.dtype == np.float64
    for i in np.flatnonzero(res.status == int(OPT)):
        assert relative_gap(float(res.z[i]), float(jres.z[i])) <= GAP, i
        if stack is not None:
            assert relative_gap(float(res.z[i]), solve_scipy(*(s[i] for s in stack)).z) <= GAP, i


@pytest.mark.parametrize("mesh", [None, 2])
@pytest.mark.parametrize("name", list(BATCH_SETS))
def test_solve_batched_f64(pool, name, mesh):
    stack = batch_stack()
    opts = SimplexOptions(dtype=F64, **BATCH_SETS[name])
    if mesh is None:
        res = solve_batched(*stack, options=opts, device="cpu")
    else:
        res = pool.run("batched", mesh, *stack, opts)[0]
    same_batch(res, jax_batched(name), stack if name == "dantzig" else None)


def test_solve_batched_f64_against_pallas_interpret():
    """At 3 x 16 x 128 the JAX package's pallas backend runs its kernels
    (interpret mode on the CPU) under vmap in float64."""
    stack = batch_stack(3, 16, 128, seed0=0)
    res = solve_batched(*stack, options=SimplexOptions(dtype=F64), device="cpu")
    same_batch(res, jax_batched("dantzig", "pallas", (3, 16, 128, 0)), stack)


@functools.lru_cache(maxsize=None)
def warm_case():
    A, b, c = random_dense_lp(12, 30, seed=31, dtype=np.float64)
    rng = np.random.default_rng(9)
    bs2 = np.stack([b * (1 + 0.2 * rng.uniform(-1, 1, b.shape)) for _ in range(8)])
    opts = dict(refactor_every=64)
    cold = solve(A, b, c, options=SimplexOptions(dtype=F64, **opts), device="cpu")
    jcold = jax_solve(A, b, c, options=JaxOptions(dtype=jnp.float64, **opts))
    jres = jax_reoptimize_batched(A, bs2, c, jcold, options=JaxOptions(dtype=jnp.float64, **opts))
    return A, bs2, c, cold, jres


@pytest.mark.parametrize("mesh", [None, 2])
@pytest.mark.parametrize("storage", ["dense", "csc"])
def test_reoptimize_batched_f64(pool, storage, mesh):
    A, bs2, c, cold, jres = warm_case()
    A_in = A if storage == "dense" else sps.csc_matrix(A)
    opts = SimplexOptions(dtype=F64, refactor_every=64)
    if mesh is None:
        res = reoptimize_batched(A_in, bs2, c, cold, options=opts, device="cpu")
    else:
        res = pool.run("reoptimized", mesh, A_in, bs2, c, cold, opts)[0]
    same_batch(res, jres)
    for i in range(len(bs2)):
        ref = solve_scipy(A, bs2[i], c)
        assert SolveStatus(int(res.status[i])) == ref.status, i
        if ref.status == OPT:
            assert relative_gap(float(res.z[i]), ref.z) <= GAP and float(res.feas_err[i]) <= GAP, i


# ---- the batched wrappers in float64 -----------------------------------------


def test_batched_wrappers_take_f64_and_refuse_a_mixed_call():
    g = torch.Generator().manual_seed(5)
    B, m, n = 3, 5, 11
    y, A, c = (torch.randn(*s, generator=g, dtype=F64) for s in ((B, m), (B, m, n), (B, n)))
    basis = torch.stack([torch.randperm(n, generator=g)[:m] for _ in range(B)]).to(torch.int32)
    bland = torch.tensor([False, True, False])
    for A_in in (A, A.to(torch.bfloat16)):
        p, min_e = hopper.choose_entering_batched(y, A_in, c, 1e-9, bland, basis)
        p_p, min_p = ops.choose_entering_batched(y, A_in, c, 1e-9, bland, basis)
        assert min_e.dtype == F64 and torch.equal(p, p_p) and torch.equal(min_e, min_p)
    for args, what in (((y.float(), A, c), "y"), ((y, A.float(), c), "A"), ((y, A, c.float()), "A|y")):
        with pytest.raises(ValueError, match=what):
            hopper.choose_entering_batched(*args, 1e-9, bland, basis)
    B_inv = torch.randn(B, m, m, generator=g, dtype=F64)
    eta, row = torch.randn(B, m, generator=g, dtype=F64), torch.randn(B, m, generator=g, dtype=F64)
    got = hopper.rank1_update_batched(B_inv.clone(), eta, row, bland)
    assert torch.equal(got, ops.rank1_update_batched(B_inv.clone(), eta, row, bland))
    with pytest.raises(ValueError, match="eta"):
        hopper.rank1_update_batched(B_inv, eta.float(), row, bland)
    x_b = torch.rand(B, m, generator=g, dtype=F64)
    scal = [-torch.rand(B, generator=g, dtype=F64) for _ in range(2)] + [torch.randn(B, generator=g, dtype=F64)]
    ints = [torch.zeros(B, dtype=torch.int32) for _ in range(4)]
    kw = dict(eps=1e-9, pivot_tol=1e-7, feas_tol=1e-6, harris=True, degen_tol=1e-9, bland_after=0)
    args = [x_b, eta, basis, y, row, B_inv, *scal, *ints, torch.ones(B, dtype=torch.bool)]
    t = hopper.pivot_tail_batched(*args, **kw)
    assert t.theta_q.dtype == F64 and t.x_b.dtype == F64
    with pytest.raises(ValueError, match="B_inv"):
        hopper.pivot_tail_batched(*args[:5], B_inv.float(), *args[6:], **kw)


@pytest.mark.parametrize(
    "shape, shared, bf16, align, window, want",
    [
        # bench.py --mode batch's shape in float64: one launch
        ((4096, 64, 160), False, False, 16, 0, dict(layout="scan", chunks=1, scratch_words=0, launches=1)),
        # the bf16 shadow beside float64 vectors: four columns a thread
        ((4096, 64, 160), False, True, 16, 0, dict(layout="bf16x4", threads=64)),
        # the shared product on the FP64 tensor cores: bulk copies of 8-byte
        # elements, CTAs of 128 instances x 64 columns (8 warps of mma and a
        # producer warp), 4-word records
        ((256, 2048, 4096), True, False, 16, 0, dict(layout="shared", chunks=64, words=128,
                                                   grid=(64, 2), threads=288, launches=3,
                                                   scratch_words=256 * 128 + 256 * 64 * 4)),
        # n odd: rows of 8 n bytes are not a multiple of 16
        ((130, 260, 1001), True, False, 16, 0, dict(layout="shared_loads")),
        # 325 mask words: one pad word keeps the records 8-byte aligned
        ((65, 33, 129), True, False, 16, 0, dict(layout="shared_loads", chunks=3,
                                                 scratch_words=65 * 5 + 1 + 65 * 3 * 4)),
        # one past the tile on B and n (129 instances, 130 columns), copies
        ((129, 64, 130), True, False, 16, 0, dict(layout="shared", chunks=3, grid=(3, 2),
                                                  threads=288, reduce=True, launches=3)),
        # one tile covers n: no reduction launch
        ((3, 16, 64), True, False, 16, 0, dict(layout="shared", chunks=1, grid=(1, 1),
                                               reduce=False, launches=2, scratch_words=3 * 2)),
        # y or A one element off 16 bytes: element loads; the bf16 shadow too
        ((256, 2048, 4096), True, False, 8, 0, dict(layout="shared_loads", chunks=64, grid=(64, 2),
                                                  threads=256)),
        ((256, 2048, 4096), True, True, 2, 0, dict(layout="shared_loads", chunks=64)),
        ((256, 2048, 4096), True, True, 16, 0, dict(layout="shared", chunks=64, threads=288)),
        # the window by bulk copies: w = 512 is 4 KB a row of the box
        ((64, 512, 4096), False, False, 16, 512, dict(layout="window_tma", threads=288, chunks=2, reduce=False)),
        # w = 15: 120 bytes, no bulk copy
        ((64, 512, 4096), False, False, 16, 15, dict(layout="scan")),
        # the grouped window on the FP64 tensor cores: tiles of 32 grouped
        # instances x 64 window columns, 256 threads, the grouping table in
        # tiles of 32 (ceil(B / 32) + S - 1 instance tiles)
        ((256, 2048, 4096), True, False, 16, 512, dict(layout="window_group", chunks=8, grid=(8, 15),
                                                     threads=256, group_tiles=15, launches=3)),
        ((256, 2048, 4096), True, False, 8, 512, dict(layout="window_group_loads", chunks=8)),
        ((256, 2048, 4096), True, True, 2, 512, dict(layout="window_group_loads", chunks=8)),
        # tails: B = 33 (two table tiles), w = 72 (a tile of 8 columns), copies
        ((33, 64, 576), True, False, 16, 72, dict(layout="window_group", chunks=2, grid=(2, 9),
                                                 group_tiles=9, reduce=True, launches=3)),
        # w = 65: 520 bytes, element loads; one tile of 64 columns and one of 1
        ((37, 16, 520), True, False, 16, 65, dict(layout="window_group_loads", chunks=2, grid=(2, 9))),
        # w = 64: one tile covers the window, no reduction launch
        ((1, 16, 512), True, False, 16, 64, dict(layout="window_group", chunks=1, grid=(1, 8),
                                                reduce=False, launches=2)),
    ],
)
def test_batch_pricing_plan_8_byte_vectors(shape, shared, bf16, align, window, want):
    plan = hopper.batch_pricing_plan(*shape, shared=shared, bf16=bf16, align=align, window=window,
                                     segments=8 if window else 0, elem=8)
    assert {k: plan[k] for k in want} == want


def test_batch_pricing_plan_refuses_other_vector_sizes():
    with pytest.raises(ValueError, match="bytes"):
        hopper.batch_pricing_plan(4, 8, 16, shared=False, bf16=False, align=16, elem=2)


@pytest.mark.parametrize(
    "m, align, want",
    [
        (32, 16, ("warp", 1, 1)), (64, 16, ("warp", 2, 2)), (64, 8, ("warp", 2, 1)),
        (100, 16, ("warp", 4, 4)), (256, 16, ("warp", 8, 4)), (257, 16, ("block", 0, 1)),
    ],
)
def test_batch_tail_plan_8_byte_rows(m, align, want):
    """In float64 a group of 2 or 4 rows needs 16-byte alignment (one or
    two double2 loads); the paths change at 256 rows, as in float32."""
    plan = hopper.batch_tail_plan(37, m, align, 8)
    assert (plan["path"], plan["rows_per_lane"], plan["vec"]) == want
