"""Post-solve sensitivity analysis (rhs and cost ranging) and the warm
re-solve after a rhs change: ``simplex_tpu.analysis`` on the port.

Over what range can a right-hand side b_i or an objective coefficient c_j
move before the optimal BASIS changes, and how does the optimum move inside
that range (rate y_i for b_i; rate x_j for c_j of a basic column)?

    max c.x  s.t.  A x = b, x >= 0,  optimal basis B:
      rhs ranging    x_b(t)  = x_b + t B_inv[:, i]  must stay >= 0
      cost ranging   nonbasic j: red_j = y.A_j - c_j >= 0 must stay so:
                     c_j may rise by red_j and fall freely
                     basic j (row r): red_k(t) = red_k + t (B_inv[r] A)_k
                     must stay >= 0 over all nonbasic k

Everything is derived from the final basis on the device: one Newton-Schulz
re-inversion (:mod:`simplex_tpu_torch.core.linalg`, its residual checked,
with a float64 LU on the same device behind it), the (m, m) x (m, n) product
W = B_inv A and masked row minima / maxima, all plain torch ops in full
fp32; only O(m + n) vectors come back to the host. A sparse A never
materializes W: the cost-ranging reductions run over column chunks, each
gathered dense and multiplied by B_inv (``_ranging_jit_sparse``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.config import DEFAULT_OPTIONS, pin_full_fp32
from simplex_tpu_torch.core.linalg import inverse_newton
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.logging import get_logger

_EPS = 1e-12  # entries of B_inv and W below this constrain nothing


class RangingResult(NamedTuple):
    """Allowable DELTAS (not absolute values), per row / per column.

    ``b_lo[i] <= delta_b_i <= b_hi[i]`` keeps the basis optimal; within the
    range the optimum moves at rate ``y[i]`` per unit of b_i. The same for
    costs: ``c_lo[j] <= delta_c_j <= c_hi[j]``, with the optimum moving at
    rate ``x[j]`` (nonzero only for basic columns).
    """

    b_lo: np.ndarray  # (m,)
    b_hi: np.ndarray  # (m,)
    c_lo: np.ndarray  # (n,)
    c_hi: np.ndarray  # (n,)
    y: np.ndarray  # (m,) duals (dz/db)
    x: np.ndarray  # (n,) primal (dz/dc)
    # False only when even the float64 LU failed (a numerically singular
    # basis): the ranges are garbage then
    ok: bool = True


def _cost_rows(A, B_inv, red, nonbasic, chunk: int = 512):
    """Per row r of the tableau W = B_inv A: the least upper and the largest
    lower cost-ranging bound over the nonbasic columns. Dense A: W at once;
    sparse A: ``chunk`` columns at a time, so W is never held whole."""
    if isinstance(A, _sp.SparseA):
        n = A.shape[1]
        ups, los = [], []
        for lo in range(0, n, chunk):
            ids = torch.arange(lo, min(lo + chunk, n), device=B_inv.device)
            Wc = B_inv @ _sp.gather_columns(A, ids).to(B_inv.dtype)
            up, low = _cost_rows(Wc, None, red[lo : lo + Wc.shape[1]], nonbasic[lo : lo + Wc.shape[1]])
            ups.append(up)
            los.append(low)
        return torch.stack(ups).amin(0), torch.stack(los).amax(0)
    W = A if B_inv is None else B_inv @ A  # (m, n): row r is w
    q = -red[None, :] / W
    up_rows = torch.where(nonbasic[None, :] & (W < -_EPS), q, math.inf).amin(1)
    lo_rows = torch.where(nonbasic[None, :] & (W > _EPS), q, -math.inf).amax(1)
    return up_rows, lo_rows


def _ranges(A, b, c, basis, B_inv):
    """The six vectors of :class:`RangingResult` on the device
    (``simplex_tpu.analysis._ranging_jit``, or ``_ranging_jit_sparse``
    for a sparse A)."""
    n = A.shape[1]
    idx = basis.long()
    x_b = B_inv @ b
    y = c.index_select(0, idx) @ B_inv
    red = _ops.reduced_costs(y, A, c)  # >= 0 at optimality

    # rhs ranging: x_b + t B_inv[:, i] >= 0 for every column i of B_inv
    D = B_inv
    ratio = -x_b[:, None] / torch.where(D.abs() > _EPS, D, math.inf)
    b_lo = torch.where(D > _EPS, ratio, -math.inf).amax(0)
    b_hi = torch.where(D < -_EPS, ratio, math.inf).amin(0)
    del ratio

    # cost ranging. Nonbasic j: c_j may rise until red_j hits 0. Basic j in
    # row r: raising c_j by t moves red_k by t w_k with w = B_inv[r] A, and
    # red_k(t) >= 0 must hold over the nonbasic k:
    #   w_k > 0  ->  t >= -red_k / w_k;   w_k < 0  ->  t <= -red_k / w_k
    nonbasic = torch.ones(n, dtype=torch.bool, device=A.device).index_fill_(0, idx, False)
    up_rows, lo_rows = _cost_rows(A, B_inv, red, nonbasic)
    c_lo = torch.full_like(red, -math.inf).index_copy_(0, idx, lo_rows)
    c_hi = red.index_copy(0, idx, up_rows)
    x = torch.zeros_like(red).index_copy_(0, idx, x_b)
    return b_lo, b_hi, c_lo, c_hi, y, x


def ranging(A, b, c, basis, *, device="cuda") -> RangingResult:
    """Sensitivity ranges for the optimal ``basis`` (``SolveResult.basis``),
    computed on ``device`` (default ``"cuda"``; there is no fallback to the
    CPU). Degenerate optima can make ranges one-sided zeros.

    The basis is re-inverted by Newton-Schulz and the residual is checked:
    an ill-conditioned basis that stalls the fp32 iteration falls back to a
    float64 LU inversion on the device, so the ranges never come from a bad
    inverse; ``ok=False`` reports a basis even that could not invert.
    ``A`` may be sparse (scipy.sparse or a
    :class:`~simplex_tpu_torch.sparse.SparseA`)."""
    pin_full_fp32()
    device = torch.device(device)

    def put(v):
        v = v if isinstance(v, torch.Tensor) else np.asarray(v)
        return torch.as_tensor(v, device=device).to(torch.float32)

    A_d = _sp.as_sparse(A, torch.float32, device) if _sp.is_sparse(A) else put(A)
    b_d, c_d = put(b), put(c)
    basis_d = torch.as_tensor(np.asarray(basis, np.int32), device=device)
    B = _ops.gather_basis_matrix(A_d, basis_d)
    B_inv, resid = inverse_newton(B)
    ok = math.isfinite(resid) and resid <= 1e-3
    if not ok:
        get_logger("analysis").warning(
            "ranging: Newton-Schulz re-inversion stalled (residual %g); "
            "falling back to a float64 LU inversion", resid,
        )
        try:
            B_inv = torch.linalg.inv(B.double()).to(torch.float32)
            ok = bool(torch.isfinite(B_inv).all())
        except torch.linalg.LinAlgError:
            ok = False  # singular basis: report, don't raise
    out = _ranges(A_d, b_d, c_d, basis_d, B_inv)
    b_lo, b_hi, c_lo, c_hi, y, x = (v.cpu().numpy() for v in out)
    return RangingResult(b_lo=b_lo, b_hi=b_hi, c_lo=c_lo, c_hi=c_hi, y=y, x=x, ok=ok)


def reoptimize(A, b_new, c, prev, *, u=None, options=None, device="cuda"):
    """Re-solve after a rhs change, warm-started from a prior optimal basis
    (``prev``, the :class:`~simplex_tpu_torch.core.solver.SolveResult` of the
    original solve: its basis is dual-feasible for any b).

    Pairs with :func:`ranging`: a delta-b inside the allowable range keeps
    the basis (the dual loop exits in 0 pivots and only the values are
    re-derived); outside it, the dual simplex pivots to the new optimal
    basis. For a cost change use the primal warm start,
    ``solve(A, b, c_new, basis0=prev.basis)``."""
    from simplex_tpu_torch.core.dual import solve_dual

    return solve_dual(
        A, b_new, c, basis0=prev.basis, u=u,
        at_upper0=getattr(prev, "at_upper", None),
        options=options if options is not None else DEFAULT_OPTIONS,
        device=device,
    )
