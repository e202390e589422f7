"""Crossover: purify a first-order (PDHG) solution to an exact vertex.

The counterpart of ``simplex_tpu.fo.crossover``: identify a basis from the
first-order point by a host QR with column pivoting on A with its columns
weighted by each column's activity into its box (scipy), park the
near-upper columns at their bound, and hand the basis to the simplex core
(``solve(basis0=, at_upper0=)``), which walks the few pivots from the face
interior to the optimal vertex with the full OPTIMAL contract (verify
rounds, f64 polish, feas_err, duals). A singular identified basis surfaces
as a SINGULAR solve.
"""

from __future__ import annotations

import numpy as np

from simplex_tpu_torch.config import DEFAULT_OPTIONS, SimplexOptions
from simplex_tpu_torch.core.solver import SolveResult, solve


def identify_basis(A, x, u=None):
    """m independent columns, the first-order support first: QR with column
    pivoting on A with column j scaled by its activity (x_j, or its distance
    to the nearer bound of a bounded column). Returns ``(basis,
    at_upper0)`` (the near-upper columns, none of them basic)."""
    import scipy.sparse as sps
    from scipy.linalg import qr

    if sps.issparse(A):
        A = A.toarray()  # the pivoted QR is dense
    A = np.asarray(A, np.float64)
    m, n = A.shape
    x = np.asarray(x, np.float64)
    w = np.maximum(x, 0.0).copy()
    up_mask = np.zeros(n, bool)
    if u is not None:
        u64 = np.asarray(u, np.float64)
        finite = np.isfinite(u64)
        scale = 1.0 + np.where(finite, u64, 0.0)
        up_mask = finite & (u64 - x <= 1e-5 * scale)
        w = np.where(finite, np.minimum(w, np.maximum(u64 - x, 0.0)), w)
    # a tiny floor keeps the zero-weight columns orderable
    col_norm = np.maximum(np.linalg.norm(A, axis=0), 1e-30)
    wn = w / (1.0 + np.abs(w).max())
    Aw = A * (wn + 1e-9)[None, :] / col_norm[None, :]
    _q, _r, piv = qr(Aw, mode="economic", pivoting=True)
    basis = np.sort(np.asarray(piv[:m], np.int32))
    at_upper0 = up_mask.copy()
    at_upper0[basis] = False
    return basis, at_upper0


def crossover(
    A,
    b,
    c,
    fo_result,
    *,
    u=None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    device="cuda",
) -> SolveResult:
    """The exact basic optimum reached from a
    :class:`~simplex_tpu_torch.fo.pdhg.PDHGResult` (any object with an
    ``x`` of length n) of the same instance, by a simplex solve on
    ``device`` from the identified basis. A may be dense or sparse."""
    x = np.asarray(fo_result.x, np.float64)
    A_host = A.cpu().numpy() if hasattr(A, "cpu") and not hasattr(A, "tocoo") else A
    if hasattr(A_host, "host"):  # a SparseA: its float64 scipy copy
        A_host = A_host.host
    basis0, at_upper0 = identify_basis(A_host, x, u=u)
    return solve(
        A, b, c, u=u, basis0=basis0, at_upper0=at_upper0 if u is not None else None,
        options=options, device=device,
    )
