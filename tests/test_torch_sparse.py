"""The port's sparse A (``simplex_tpu_torch.sparse``) against the JAX
package's ``simplex_tpu.sparse`` on the same matrices: each random matrix is
built as a JAX ``BlockSparse`` and carried across by ``from_block_sparse``,
so both packages hold the same nonzeros. Mirrors the op tests of
``tests/test_sparse.py`` and ``tests/test_sparse_core.py``.

Tolerances: gathers, absmax and the carried matrix exactly (they move
values, they do not sum them); products to rtol 1e-5 / atol 1e-5 in fp32
(sums in another order).
"""

import numpy as np
import pytest
import scipy.sparse as sps
import torch

from simplex_tpu import sparse as bsp
from simplex_tpu_torch import sparse as sp
from simplex_tpu_torch.kernels import hopper, ops

TOL = dict(rtol=1e-5, atol=1e-5)


def pair(m, n, density, seed, block=(16, 16)):
    """(dense A, JAX BlockSparse, port SparseA) of one random matrix."""
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(m, n))
    A[rng.uniform(size=(m, n)) > density] = 0.0
    A = A.astype(np.float32)
    M = bsp.from_dense(A, block_shape=block)
    P = sp.from_block_sparse(np.asarray(M.tiles), np.asarray(M.rows), np.asarray(M.cols),
                             M.shape, device="cpu")
    return A, M, P


@pytest.mark.parametrize("m,n", [(30, 70), (128, 200), (16, 16)])
def test_carried_matrix_and_products(m, n):
    A, M, P = pair(m, n, 0.1, seed=m + n)
    assert P.shape == (m, n) and P.nnz == np.count_nonzero(A)
    np.testing.assert_array_equal(P.to_dense().numpy(), A)
    np.testing.assert_array_equal(P.host.toarray(), A.astype(np.float64))
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=n).astype(np.float32), rng.normal(size=m).astype(np.float32)
    np.testing.assert_allclose(sp.matvec(P, torch.as_tensor(x)).numpy(),
                               np.asarray(bsp.matvec(M, x)), **TOL)
    np.testing.assert_allclose(sp.rmatvec(P, torch.as_tensor(y)).numpy(),
                               np.asarray(bsp.rmatvec(M, y)), **TOL)
    w, v = sp.rmatvec2(P, torch.as_tensor(y), torch.as_tensor(2 * y))
    np.testing.assert_allclose(w.numpy(), y @ A, **TOL)
    np.testing.assert_allclose(v.numpy(), 2 * y @ A, **TOL)


def test_gather_column_matches_jax():
    A, M, P = pair(30, 70, 0.1, seed=11)
    for j in (0, 3, 29, 31, 69):
        got = sp.gather_column(P, torch.tensor(j, dtype=torch.int32)).numpy()
        np.testing.assert_array_equal(got, np.asarray(bsp.gather_column(M, j)))
        np.testing.assert_array_equal(got, A[:, j])


def test_gather_columns_matches_jax_and_chunks(monkeypatch):
    A, M, P = pair(40, 90, 0.08, seed=12)
    idx = np.array([0, 5, 5, 33, 89, 17, 2], np.int32)
    want = np.asarray(bsp.gather_columns(M, idx))
    np.testing.assert_array_equal(sp.gather_columns(P, torch.as_tensor(idx)).numpy(), want)
    # the chunked path: a few columns' worth of scratch per chunk
    monkeypatch.setattr(sp, "_GATHER_ENTRIES", 3 * P.k_max)
    np.testing.assert_array_equal(sp.gather_columns(P, torch.as_tensor(idx)).numpy(), want)
    np.testing.assert_array_equal(ops.gather_basis_matrix(P, torch.as_tensor(idx)).numpy(), want)


def test_gather_columns_host_matches_jax():
    A, M, P = pair(25, 50, 0.15, seed=13)
    idx = np.array([1, 24, 49, 8])
    np.testing.assert_array_equal(sp.gather_columns_host(P, idx), bsp.gather_columns_host(M, idx))


def test_empty_columns_and_k_max():
    # the fixed-length gather must zero what lies past a column's end, also
    # next to an empty column and in the last column
    A = np.zeros((6, 5), np.float32)
    A[[0, 2, 5], 1] = [1, 2, 3]
    A[4, 4] = 7
    P = sp.from_dense(A, device="cpu")
    assert P.k_max == 3
    for j in range(5):
        np.testing.assert_array_equal(
            sp.gather_column(P, torch.tensor(j)).numpy(), A[:, j])


def test_absmax_sumsq_and_scale_match_jax():
    A, M, P = pair(30, 50, 0.2, seed=3)
    np.testing.assert_array_equal(sp.row_absmax(P).numpy(), np.asarray(bsp.row_absmax(M)))
    np.testing.assert_array_equal(sp.col_absmax(P).numpy(), np.asarray(bsp.col_absmax(M)))
    assert float(sp.absmax(P)) == float(bsp.absmax(M))
    np.testing.assert_allclose(sp.col_sumsq(P).numpy(), np.asarray(bsp.col_sumsq(M)), **TOL)
    rng = np.random.default_rng(4)
    r = rng.uniform(0.5, 2, 30).astype(np.float32)
    c = rng.uniform(0.5, 2, 50).astype(np.float32)
    S = sp.scale(P, r, c)
    np.testing.assert_allclose(S.to_dense().numpy(), np.asarray(bsp.scale(M, r, c).to_dense()), **TOL)


def test_split_columns_matches_jax():
    A, M, P = pair(20, 64, 0.2, seed=5, block=(8, 8))
    segs = sp.split_columns(P, 4)
    jsegs = bsp.split_columns(M, 4)
    assert len(segs) == len(jsegs) == 4
    for s, js in zip(segs, jsegs):
        assert s.shape == js.shape == (20, 16)
        np.testing.assert_array_equal(s.to_dense().numpy(), np.asarray(js.to_dense()))
    with pytest.raises(ValueError, match="divisible"):
        sp.split_columns(P, 5)


def test_from_scipy_matches_from_dense_and_drops_zeros():
    A, _, P = pair(24, 40, 0.2, seed=6)
    coo = sps.coo_matrix(A)
    # an explicit zero and a duplicate entry: dropped and summed
    data = np.concatenate([coo.data, [0.0, 1.0, 2.0]])
    row = np.concatenate([coo.row, [0, 23, 23]])
    col = np.concatenate([coo.col, [0, 39, 39]])
    B = A.copy()
    B[23, 39] += 3.0
    Q = sp.from_scipy(sps.coo_matrix((data, (row, col)), shape=A.shape), device="cpu")
    np.testing.assert_array_equal(Q.to_dense().numpy(), B)
    np.testing.assert_array_equal(sp.from_dense(A, device="cpu").to_dense().numpy(),
                                  P.to_dense().numpy())


def test_all_zero_matrix_stays_well_posed():
    P = sp.from_dense(np.zeros((5, 7)), device="cpu")
    assert P.nnz == 0 and P.k_max == 0
    assert float(sp.absmax(P)) == 0.0
    np.testing.assert_array_equal(sp.rmatvec(P, torch.ones(5)).numpy(), np.zeros(7))
    np.testing.assert_array_equal(sp.gather_column(P, torch.tensor(3)).numpy(), np.zeros(5))
    np.testing.assert_array_equal(sp.row_absmax(P).numpy(), np.zeros(5))


def test_sparse_a_takes_no_bf16_shadow():
    # the SpMV reads float32 values and int32 indices whatever the values
    # were rounded to: a bf16 shadow of a SparseA would save no byte, so
    # pricing reads A itself (segments too); a dense A keeps its shadow
    from simplex_tpu_torch import SimplexOptions
    from simplex_tpu_torch.core.solver import build_problem
    from simplex_tpu_torch.core.state import Problem, with_pricing_shadow

    A, _, P = pair(16, 32, 0.3, seed=7)
    prob = Problem(A=P, b=torch.ones(16), c=torch.ones(32))
    assert with_pricing_shadow(prob, "bfloat16") is prob
    assert P.val.dtype == P.csr_t.values().dtype == torch.float32
    assert P.row_idx.dtype == P.col_ptr.dtype == torch.int32
    opts = SimplexOptions(pricing_dtype="bfloat16", partial_pricing=4, partial_min_segment=1)
    built = build_problem(P, np.ones(16), np.ones(32), opts, "cpu")
    assert built.A_price is None and all(s.val.dtype == torch.float32 for s in built.A_segs)
    dense = build_problem(A, np.ones(16), np.ones(32), opts, "cpu")
    assert dense.A_price.dtype == torch.bfloat16


@pytest.mark.parametrize("backend", ["torch", "hopper"])
def test_ops_dispatch_on_sparse(backend):
    # every op that reads A gives on a SparseA what it gives on dense A;
    # the hopper wrappers take the plain ops there (CPU tensors here)
    A, _, P = pair(24, 48, 0.25, seed=8)
    At = torch.as_tensor(A)
    g = torch.Generator().manual_seed(1)
    y, c, x = torch.randn(24, generator=g), torch.randn(48, generator=g), torch.randn(48, generator=g)
    basis = torch.arange(24, 48, dtype=torch.int32)
    no = torch.tensor(False)
    up = torch.rand(48, generator=g) > 0.5
    ns = hopper if backend == "hopper" else ops
    for got, want in [
        (ops.reduced_costs(y, P, c), ops.reduced_costs(y, At, c)),
        (ops.matvec(P, x), ops.matvec(At, x)),
        (ops.pricing_update(P, y), ops.pricing_update(At, y)),
        (ops.pricing_update2(P, y, 2 * y)[1], ops.pricing_update2(At, y, 2 * y)[1]),
    ]:
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)
    p_s, e_s = ns.choose_entering(y, P, c, 1e-6, no, basis)
    p_d, e_d = ops.choose_entering(y, At, c, 1e-6, no, basis)
    assert int(p_s) == int(p_d) and float(e_s) == pytest.approx(float(e_d), rel=1e-5)
    p_s, e_s = ns.choose_entering_bounded(y, P, c, up, basis, 0, 1e-6, no)
    p_d, e_d = ops.choose_entering_bounded(y, At, c, up, basis, 0, 1e-6, no)
    assert int(p_s) == int(p_d) and float(e_s) == pytest.approx(float(e_d), rel=1e-5)
    p = torch.tensor(7, dtype=torch.int32)
    np.testing.assert_array_equal(ops.gather_column(P, p).numpy(), A[:, 7])


def test_masked_argmin_keeps_lowest_index_ties():
    # two columns with the same reduced cost: the lower index wins, as in
    # the pricing kernel
    A = np.zeros((2, 6), np.float32)
    A[0, 1] = A[0, 4] = 1.0
    P = sp.from_dense(A, device="cpu")
    y = torch.tensor([-1.0, 0.0])
    c = torch.zeros(6)
    p, min_e = ops.choose_entering(y, P, c, 1e-6, torch.tensor(False))
    assert int(p) == 1 and float(min_e) == -1.0


def test_is_sparse_and_as_sparse():
    A = np.eye(3, dtype=np.float32)
    assert not sp.is_sparse(A) and not sp.is_sparse(torch.as_tensor(A))
    assert sp.is_sparse(sps.csr_matrix(A))
    P = sp.as_sparse(sps.csr_matrix(A), torch.float64, "cpu")
    assert sp.is_sparse(P) and P.dtype == torch.float64
    assert sp.as_sparse(P, torch.float64, "cpu") is P
    assert P.to(dtype=torch.float32).dtype == torch.float32


def test_sparse_torch_tensor_input():
    A = np.zeros((3, 5), np.float32)
    A[0, 1], A[2, 4], A[1, 0] = 2.0, -1.0, 0.5
    for t in (torch.as_tensor(A).to_sparse(), torch.as_tensor(A).to_sparse_csr()):
        assert sp.is_sparse(t)
        np.testing.assert_array_equal(sp.as_sparse(t, torch.float32, "cpu").to_dense().numpy(), A)
