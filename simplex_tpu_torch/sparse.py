"""Sparse A for the simplex core on a GPU: ``simplex_tpu.sparse`` on the port.

The JAX package stores a sparse A as dense 128 x 128 tiles (``BlockSparse``)
because the TPU's matrix unit wants whole tiles. A GPU has no such unit to
feed, and cuSPARSE reads compressed rows directly, so the port keeps only
the nonzeros, in two layouts on the device:

  csr    CSR of A (m, n):      ``matvec``   A x    (bounded rhs, dual flips)
  csr_t  CSR of A^T (n, m):    ``rmatvec``  y.A    (pricing, e = y.A - c,
                               and the devex / steepest-edge row passes)

CSR of A^T is CSC of A, so its arrays also serve the column gathers.
``gather_column`` (the entering column of every pivot) must not read the
column's extent back to the host, which would be one more sync a pivot.
It reads a fixed ``k_max`` entries from ``col_ptr[p]`` (the largest column
count, known on the host when the matrix is built), zeroes those past
``col_ptr[p + 1]`` and scatters them into a dense (m,) vector: a handful of
small launches and no read. ``gather_columns`` does the same for a set of
columns, in chunks that bound its scratch.

A host copy (scipy CSC, float64) rides along: the f64 polish, the light
checkpoint resume and the entry checks take A's columns from it, as the
JAX package takes them from its scipy reference.

Values carry the solve's dtype. A sparse A takes no bfloat16 pricing
shadow: the SpMV reads float32 values and int32 indices either way, so the
JAX package's bf16 tiles have no byte to save here.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
import torch

# entries a chunked column gather holds at once (k_max per column)
_GATHER_ENTRIES = 1 << 24


def _csr_tensor(ptr, idx, val, shape):
    with warnings.catch_warnings():
        # torch flags CSR as beta and the invariant check as off, once a
        # process: the arrays here come from scipy, whose CSR is valid
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(ptr, idx, val, shape, check_invariants=False)


class SparseA:
    """An (m, n) sparse matrix on one device (see the module docstring).

    ``col_ptr`` (n + 1,) int32, ``row_idx`` (nnz,) int32 and ``val``
    (nnz,) are the CSC arrays (shared with ``csr_t``); ``host`` is the
    scipy CSC in float64; ``k_max`` the most nonzeros in one column.
    Build with :func:`from_scipy`, :func:`from_dense` or
    :func:`from_block_sparse`."""

    ndim = 2

    def __init__(self, host, device, dtype):
        self.host = host
        self.shape = (int(host.shape[0]), int(host.shape[1]))
        m, n = self.shape
        dev = torch.device(device)
        csc = host
        csr = host.tocsr()

        def idx(a):
            return torch.as_tensor(np.asarray(a, np.int32), device=dev)

        def vals(a):
            return torch.as_tensor(np.asarray(a, np.float64), device=dev).to(dtype)

        self.col_ptr, self.row_idx, self.val = idx(csc.indptr), idx(csc.indices), vals(csc.data)
        self.csr_t = _csr_tensor(self.col_ptr, self.row_idx, self.val, (n, m))
        self.csr = _csr_tensor(idx(csr.indptr), idx(csr.indices), vals(csr.data), (m, n))
        counts = np.diff(csc.indptr)
        self.k_max = int(counts.max()) if n else 0
        self._k = torch.arange(max(self.k_max, 1), device=dev)

    @property
    def dtype(self) -> torch.dtype:
        return self.val.dtype

    @property
    def device(self) -> torch.device:
        return self.val.device

    @property
    def nnz(self) -> int:
        return int(self.val.shape[0])

    def to(self, device=None, dtype=None) -> "SparseA":
        """This matrix on ``device`` in ``dtype`` (itself when both match)."""
        device = self.device if device is None else torch.device(device)
        dtype = self.dtype if dtype is None else dtype
        if device == self.device and dtype == self.dtype:
            return self
        return SparseA(self.host, device, dtype)

    def to_dense(self) -> torch.Tensor:
        return self.csr.to_dense()

    def __repr__(self) -> str:
        return f"SparseA(shape={self.shape}, nnz={self.nnz}, k_max={self.k_max}, {self.dtype}, {self.device})"


def from_scipy(sp, dtype=torch.float32, device="cuda") -> SparseA:
    """A scipy.sparse matrix on ``device`` (explicit zeros dropped)."""
    import scipy.sparse as sps

    csc = sps.csc_matrix(sp, dtype=np.float64, copy=True)
    csc.sum_duplicates()
    csc.eliminate_zeros()
    csc.sort_indices()
    return SparseA(csc, device, dtype)


def from_dense(A, dtype=torch.float32, device="cuda") -> SparseA:
    """The nonzeros of a dense host matrix (or tensor)."""
    import scipy.sparse as sps

    if isinstance(A, torch.Tensor):
        A = A.detach().cpu().numpy()
    return from_scipy(sps.csc_matrix(np.asarray(A, np.float64)), dtype, device)


def from_block_sparse(tiles, rows, cols, shape, dtype=torch.float32, device="cuda") -> SparseA:
    """The port's matrix from the arrays of a ``simplex_tpu.sparse.BlockSparse``
    (``tiles`` (T, br, bc), tile-row ids ``rows`` and tile-column ids
    ``cols`` (T,), logical ``shape``), as numpy: the same nonzeros, so both
    packages can be fed one matrix."""
    import scipy.sparse as sps

    tiles = np.asarray(tiles, np.float64)
    rows, cols = np.asarray(rows, np.int64), np.asarray(cols, np.int64)
    m, n = int(shape[0]), int(shape[1])
    br, bc = tiles.shape[1], tiles.shape[2]
    t, i, j = np.nonzero(tiles)
    r, c = rows[t] * br + i, cols[t] * bc + j
    keep = (r < m) & (c < n)
    coo = sps.coo_matrix((tiles[t, i, j][keep], (r[keep], c[keep])), shape=(m, n))
    return from_scipy(coo, dtype, device)


def matvec(M: SparseA, x: torch.Tensor) -> torch.Tensor:
    """A x, (n,) -> (m,), in the matrix's dtype."""
    return torch.mv(M.csr, x.to(M.dtype))


def rmatvec(M: SparseA, y: torch.Tensor) -> torch.Tensor:
    """y . A, (m,) -> (n,), in the matrix's dtype."""
    return torch.mv(M.csr_t, y.to(M.dtype))


def rmatvec2(M: SparseA, a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(a . A, b . A)`` from one SpMM over A^T with two right-hand sides."""
    out = M.csr_t @ torch.stack([a.to(M.dtype), b.to(M.dtype)], 1)
    return out[:, 0].contiguous(), out[:, 1].contiguous()


def rmatmat(M: SparseA, Y: torch.Tensor) -> torch.Tensor:
    """Y . A for a stack of rows Y (k, m) -> (k, n): one SpMM over A^T."""
    return (M.csr_t @ Y.to(M.dtype).T.contiguous()).T.contiguous()


def matmat(M: SparseA, X: torch.Tensor) -> torch.Tensor:
    """A . X^T for a stack of rows X (k, n) -> (k, m): one SpMM over A."""
    return (M.csr @ X.to(M.dtype).T.contiguous()).T.contiguous()


def _gather(M: SparseA, idx: torch.Tensor) -> torch.Tensor:
    """Columns ``idx`` (k,) as a dense (m, k) matrix: k_max entries read
    from each column's start, those past its end zeroed."""
    m = M.shape[0]
    k = idx.shape[0]
    out = torch.zeros(m * k, dtype=M.dtype, device=M.device)
    if M.nnz == 0 or k == 0:
        return out.view(m, k)
    idx = idx.long()
    lo = M.col_ptr.index_select(0, idx).long()
    hi = M.col_ptr.index_select(0, idx + 1).long()
    pos = lo[:, None] + M._k[None, : max(M.k_max, 1)]  # (k, k_max)
    live = pos < hi[:, None]
    pos = pos.clamp_max(M.nnz - 1).view(-1)
    rows = M.row_idx.index_select(0, pos).long().view(k, -1)
    vals = torch.where(live.view(-1), M.val.index_select(0, pos), 0)
    # row-major (m, k): entry (i, j) at i * k + j
    flat = rows * k + torch.arange(k, device=M.device)[:, None]
    return out.index_add_(0, flat.view(-1), vals).view(m, k)


def gather_column(M: SparseA, p: torch.Tensor) -> torch.Tensor:
    """Column p (a 0-d device index) as a dense (m,) vector, read from the
    device with no host read."""
    return _gather(M, p.view(1)).view(-1)


def gather_columns(M: SparseA, idx: torch.Tensor) -> torch.Tensor:
    """Columns ``idx`` as a dense (m, k) matrix, in chunks that hold at most
    about 16 M entries of scratch (the basis matrix at m = 8192 is two)."""
    k = idx.shape[0]
    chunk = max(1, _GATHER_ENTRIES // max(M.k_max, 1))
    if k <= chunk:
        return _gather(M, idx)
    return torch.cat([_gather(M, idx[i : i + chunk]) for i in range(0, k, chunk)], 1)


def gather_columns_host(M: SparseA, idx) -> np.ndarray:
    """Columns ``idx`` as a dense float64 host array, from the host copy."""
    return M.host[:, np.asarray(idx, np.int64)].toarray()


def _rows_of_nnz(M: SparseA) -> torch.Tensor:
    m = M.shape[0]
    crow = M.csr.crow_indices().long()
    return torch.repeat_interleave(torch.arange(m, device=M.device), crow.diff(), output_size=M.nnz)


def _cols_of_nnz(M: SparseA) -> torch.Tensor:
    n = M.shape[1]
    return torch.repeat_interleave(
        torch.arange(n, device=M.device), M.col_ptr.long().diff(), output_size=M.nnz
    )


def row_absmax(M: SparseA) -> torch.Tensor:
    """max_j |A_ij| per row (0 for an empty row)."""
    out = torch.zeros(M.shape[0], dtype=M.dtype, device=M.device)
    return out.scatter_reduce_(0, _rows_of_nnz(M), M.csr.values().abs(), "amax")


def col_absmax(M: SparseA) -> torch.Tensor:
    """max_i |A_ij| per column (0 for an empty column)."""
    out = torch.zeros(M.shape[1], dtype=M.dtype, device=M.device)
    return out.scatter_reduce_(0, _cols_of_nnz(M), M.val.abs(), "amax")


def absmax(M: SparseA) -> torch.Tensor:
    if M.nnz == 0:
        return torch.zeros((), dtype=M.dtype, device=M.device)
    return M.val.abs().max()


def col_sumsq(M: SparseA) -> torch.Tensor:
    """sum_i A_ij^2 per column, accumulated in at least float32."""
    acc = torch.promote_types(M.dtype, torch.float32)
    v = M.val.to(acc)
    out = torch.zeros(M.shape[1], dtype=acc, device=M.device)
    return out.index_add_(0, _cols_of_nnz(M), v * v)


def scale(M: SparseA, r, c) -> SparseA:
    """diag(r) A diag(c), built from the host copy (r (m,), c (n,))."""
    import scipy.sparse as sps

    r = np.asarray(r.cpu() if isinstance(r, torch.Tensor) else r, np.float64)
    c = np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c, np.float64)
    return from_scipy(sps.diags(r) @ M.host @ sps.diags(c), M.dtype, M.device)


def split_columns(M: SparseA, n_seg: int) -> Tuple[SparseA, ...]:
    """``n_seg`` column-range segments, each its own matrix with local
    column ids: the structures segmented pricing scans (a column range of
    a compressed matrix is not a view). n must divide by n_seg."""
    m, n = M.shape
    if n % n_seg != 0:
        raise ValueError(f"n={n} not divisible by {n_seg} segments")
    w = n // n_seg
    return tuple(
        from_scipy(M.host[:, s * w : (s + 1) * w], M.dtype, M.device) for s in range(n_seg)
    )


def is_sparse(A) -> bool:
    """A :class:`SparseA`, a scipy.sparse matrix or a sparse torch tensor."""
    if isinstance(A, SparseA):
        return True
    if isinstance(A, torch.Tensor):
        return A.layout != torch.strided
    if isinstance(A, np.ndarray):
        return False
    try:
        import scipy.sparse as sps
    except ImportError:  # pragma: no cover - scipy is a test dependency
        return False
    return sps.issparse(A)


def as_sparse(A, dtype, device) -> SparseA:
    """A :class:`SparseA` on ``device`` in ``dtype`` from a SparseA, a
    scipy.sparse matrix or a sparse torch tensor."""
    if isinstance(A, SparseA):
        return A.to(device, dtype)
    if isinstance(A, torch.Tensor):
        import scipy.sparse as sps

        coo = A.detach().cpu().to_sparse_coo().coalesce()
        i = coo.indices().numpy()
        A = sps.coo_matrix((coo.values().double().numpy(), (i[0], i[1])), shape=tuple(A.shape))
    return from_scipy(A, dtype, device)
