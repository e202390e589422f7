"""LP presolve: classic reductions + geometric-mean scaling for the
general route.

A copy of ``simplex_tpu.presolve`` for the port (numpy / scipy on the
host, as in the reference package). Real instances carry structure a
simplex core should never see: fixed variables, empty rows and columns,
and singleton rows that are bounds in disguise. This module removes them
on the host (O(nnz) per pass), so the device solver works on the
irreducible core, and equilibrates what remains so fp32 tolerances mean
the same thing on every row.

Reductions (iterated to a fixpoint):

  empty row        all-zero row: feasibility check against b, then drop.
  singleton row    one nonzero ``a·x_j (<=|>=|==) b``: tighten x_j's bounds
                   and drop the row (an E row fixes the variable).
  fixed variable   lo == up: substitute into b and the objective constant,
                   drop the column.
  empty column     variable in no remaining row: park it at its cost-optimal
                   bound (detects UNBOUNDED when that bound is infinite).

Scaling (optional, on by default): geometric-mean row/column equilibration,
2 passes — ``A' = R A S`` with positive diagonals, ``b' = R b``,
``c' = S c``, bounds divided by ``s``. Postsolve multiplies the scales back
(``x = s ⊙ x'``, ``y = r ⊙ y'``); the objective value is invariant.

Postsolve recovers the FULL primal and dual vectors, including duals for
dropped rows: an empty row's dual is 0; a dropped singleton row's dual is
``rc_j / a_ij`` when the bound it induced is the one active at the optimum
(the leftover reduced cost of its column belongs to that row), else 0.

Both dense ``np.ndarray`` and ``scipy.sparse`` A are supported; a sparse
input stays sparse through every reduction and into the reduced problem.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from simplex_tpu_torch.logging import fields, get_logger
from simplex_tpu_torch.status import SolveStatus

_log = get_logger("presolve")

_ZERO_TOL = 1e-11  # |a_ij| below this is a structural zero
_FEAS_TOL = 1e-9   # constant-row / crossed-bound feasibility slack (f64 host)


class PresolveInfo(NamedTuple):
    """Everything :func:`postsolve` needs to undo the reductions."""

    m: int                      # original row count
    k: int                      # original column count
    keep_rows: np.ndarray       # (m,) bool — rows passed to the solver
    keep_cols: np.ndarray       # (k,) bool — columns passed to the solver
    fixed_vals: np.ndarray      # (k,) f64 — value for every dropped column
    # dropped singleton rows, in drop order: (row, col, coef, kind, v)
    # where kind is 'lo'/'up'/'fix' — which side of x_col the row induced —
    # and v is the induced bound value (postsolve uses it to decide which
    # of several stacked singleton rows is the binding one).
    singletons: Tuple[Tuple[int, int, float, str, float], ...]
    row_scale: np.ndarray       # (m_red,) applied to kept rows (1.0 if off)
    col_scale: np.ndarray       # (k_red,) applied to kept cols (1.0 if off)
    lo_red: np.ndarray          # (k_red,) reduced bounds BEFORE scaling —
    up_red: np.ndarray          # postsolve uses them to classify actives
    z_const: float              # objective contribution of dropped columns


class PresolveResult(NamedTuple):
    lp: Optional["GeneralLP"]   # reduced LP; None when presolve decided alone
    info: Optional[PresolveInfo]
    # set iff lp is None: OPTIMAL (everything eliminated), INFEASIBLE, or
    # UNBOUNDED, plus the full solution for the OPTIMAL case.
    status: Optional[SolveStatus] = None
    x: Optional[np.ndarray] = None
    z: float = 0.0


def _issparse(A) -> bool:
    try:
        import scipy.sparse as sps

        return sps.issparse(A)
    except ImportError:  # pragma: no cover - scipy is a baked-in dep
        return False


def _pattern(A):
    """0/1 nonzero pattern as (csr, csc) for fast row/col slicing.

    Dense A gets the same treatment through scipy so one code path serves
    both storages.
    """
    import scipy.sparse as sps

    if _issparse(A):
        P = sps.csr_matrix(abs(A) > _ZERO_TOL)
    else:
        P = sps.csr_matrix(np.abs(np.asarray(A, np.float64)) > _ZERO_TOL)
    return P, P.tocsc()


def _row_entries(A, i, colmask):
    """(cols, vals) of row i restricted to kept columns, dense or sparse."""
    if _issparse(A):
        row = A.getrow(i).tocoo()
        sel = colmask[row.col] & (np.abs(row.data) > _ZERO_TOL)
        return row.col[sel], row.data[sel].astype(np.float64)
    r = np.asarray(A[i], np.float64)
    cols = np.flatnonzero(colmask & (np.abs(r) > _ZERO_TOL))
    return cols, r[cols]


def presolve(lp, *, scale: bool = True, max_passes: int = 8) -> PresolveResult:
    """Reduce a :class:`~simplex_tpu_torch.core.twophase.GeneralLP` (maximize)."""
    from simplex_tpu_torch.core.twophase import GeneralLP

    m, k = lp.A.shape
    b = np.asarray(lp.b, np.float64).copy()
    c = np.asarray(lp.c, np.float64).copy()
    types = list(lp.row_types)
    lo = (np.zeros(k) if lp.lower is None
          else np.asarray(lp.lower, np.float64).copy())
    up = (np.full(k, np.inf) if lp.upper is None
          else np.asarray(lp.upper, np.float64).copy())

    keep_row = np.ones(m, bool)
    keep_col = np.ones(k, bool)
    fixed_vals = np.zeros(k)
    singles: List[Tuple[int, int, float, str, float]] = []
    z_const = 0.0

    Prow, Pcol = _pattern(lp.A)

    def _infeasible() -> PresolveResult:
        return PresolveResult(lp=None, info=None,
                              status=SolveStatus.INFEASIBLE)

    for _ in range(max_passes):
        changed = False
        nnz_row = (Prow @ keep_col.astype(np.float64))
        nnz_row[~keep_row] = -1.0

        # -- empty rows: constant constraints ---------------------------
        for i in np.flatnonzero(keep_row & (nnz_row == 0)):
            t, bi = types[i], b[i]
            ok = (bi >= -_FEAS_TOL if t == "L" else
                  bi <= _FEAS_TOL if t == "G" else abs(bi) <= _FEAS_TOL)
            if not ok:
                return _infeasible()
            keep_row[i] = False
            changed = True

        # -- singleton rows: bounds in disguise --------------------------
        for i in np.flatnonzero(keep_row & (nnz_row == 1)):
            cols, vals = _row_entries(lp.A, i, keep_col)
            if len(cols) != 1:  # the pattern count can be stale mid-pass
                continue
            j, a = int(cols[0]), float(vals[0])
            t, v = types[i], b[i] / a
            # a*x_j <= b  ->  x_j <= v (a>0) | x_j >= v (a<0); G mirrored
            if t == "E":
                if v < lo[j] - _FEAS_TOL or v > up[j] + _FEAS_TOL:
                    return _infeasible()
                lo[j] = up[j] = v = min(max(v, lo[j]), up[j])
                singles.append((i, j, a, "fix", v))
            elif (t == "L") == (a > 0):
                if v < up[j]:
                    up[j] = v
                singles.append((i, j, a, "up", v))
            else:
                if v > lo[j]:
                    lo[j] = v
                singles.append((i, j, a, "lo", v))
            if lo[j] > up[j] + _FEAS_TOL:
                return _infeasible()
            keep_row[i] = False
            changed = True

        # -- fixed variables ---------------------------------------------
        fix = keep_col & (up - lo <= _FEAS_TOL) & np.isfinite(lo)
        for j in np.flatnonzero(fix):
            v = 0.5 * (lo[j] + up[j])
            if abs(v) > 0:
                col = _col_dense(lp.A, j)
                b -= col * v
                z_const += c[j] * v
            fixed_vals[j] = v
            keep_col[j] = False
            changed = True

        # -- empty columns -----------------------------------------------
        nnz_col = (Pcol.T @ keep_row.astype(np.float64))
        for j in np.flatnonzero(keep_col & (nnz_col == 0)):
            # maximize: positive cost pushes to the upper bound
            if c[j] > _ZERO_TOL:
                if not np.isfinite(up[j]):
                    return PresolveResult(lp=None, info=None,
                                          status=SolveStatus.UNBOUNDED)
                v = up[j]
            elif c[j] < -_ZERO_TOL:
                if not np.isfinite(lo[j]):
                    return PresolveResult(lp=None, info=None,
                                          status=SolveStatus.UNBOUNDED)
                v = lo[j]
            else:
                v = (lo[j] if np.isfinite(lo[j])
                     else up[j] if np.isfinite(up[j]) else 0.0)
            z_const += c[j] * v
            fixed_vals[j] = v
            keep_col[j] = False
            changed = True

        if not changed:
            break

    rows = np.flatnonzero(keep_row)
    cols = np.flatnonzero(keep_col)
    _log.info(
        "presolve reductions",
        extra=fields(rows=f"{m}->{len(rows)}", cols=f"{k}->{len(cols)}",
                     singletons=len(singles)),
    )

    if len(cols) == 0:
        # everything decided on the host; kept rows are constants — check
        x = fixed_vals.copy()
        Ax = _matvec(lp.A, x)
        for i in rows:
            r, t = Ax[i] - b[i], types[i]
            slack = max(1.0, abs(b[i])) * 1e-7
            if ((t == "L" and r > slack) or (t == "G" and r < -slack)
                    or (t == "E" and abs(r) > slack)):
                return _infeasible()
        info = PresolveInfo(
            m=m, k=k, keep_rows=keep_row, keep_cols=keep_col,
            fixed_vals=fixed_vals, singletons=tuple(singles),
            row_scale=np.ones(len(rows)), col_scale=np.ones(0),
            lo_red=np.zeros(0), up_red=np.zeros(0), z_const=z_const,
        )
        return PresolveResult(lp=None, info=info,
                              status=SolveStatus.OPTIMAL, x=x, z=z_const)

    A_red = lp.A[np.ix_(rows, cols)] if not _issparse(lp.A) else (
        lp.A.tocsr()[rows].tocsc()[:, cols]
    )
    b_red = b[rows]
    c_red = c[cols]
    lo_red = lo[cols]
    up_red = up[cols]
    types_red = [types[i] for i in rows]

    # -- geometric-mean equilibration ------------------------------------
    r_sc = np.ones(len(rows))
    s_sc = np.ones(len(cols))
    if scale and len(rows) > 0:
        import scipy.sparse as sps

        W = (sps.csr_matrix(A_red) if _issparse(A_red)
             else np.asarray(A_red, np.float64))
        for _ in range(2):
            rs = _geo_scale(W, axis=1)
            W = _scale_rows(W, rs)
            cs = _geo_scale(W, axis=0)
            W = _scale_cols(W, cs)
            r_sc *= rs
            s_sc *= cs
        A_red = W
        b_red = b_red * r_sc
        c_red = c_red * s_sc
        with np.errstate(invalid="ignore"):
            lo_s = lo_red / s_sc
            up_s = up_red / s_sc
    else:
        lo_s, up_s = lo_red, up_red

    red = GeneralLP(A=A_red, b=b_red, c=c_red, row_types=types_red,
                    lower=lo_s, upper=up_s)
    info = PresolveInfo(
        m=m, k=k, keep_rows=keep_row, keep_cols=keep_col,
        fixed_vals=fixed_vals, singletons=tuple(singles),
        row_scale=r_sc, col_scale=s_sc, lo_red=lo_red, up_red=up_red,
        z_const=z_const,
    )
    return PresolveResult(lp=red, info=info)


def postsolve(
    info: PresolveInfo,
    A,                       # the ORIGINAL A (for dual recovery)
    c: np.ndarray,           # the ORIGINAL maximize costs
    x_red: np.ndarray,
    y_red: Optional[np.ndarray],
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Map a reduced-problem solution back to the original spaces."""
    rows = np.flatnonzero(info.keep_rows)
    cols = np.flatnonzero(info.keep_cols)

    x = info.fixed_vals.copy()
    x_unscaled = np.asarray(x_red, np.float64) * info.col_scale
    x[cols] = x_unscaled

    y = None
    if y_red is not None:
        y = np.zeros(info.m)
        y[rows] = np.asarray(y_red, np.float64) * info.row_scale
        # Dropped singleton rows: the column's leftover reduced cost
        # belongs to the dropped row whose induced bound the optimum sits
        # on. Undo in REVERSE drop order — a row dropped early constrains a
        # column whose stationarity involves duals assigned by LATER
        # reductions, so rc_j must be recomputed with those already in
        # place (classic postsolve stack discipline). Once a binding row
        # takes the dual, rc_j recomputes to ~0 and stacked slack rows on
        # the same column naturally get 0.
        pos = {int(j): t for t, j in enumerate(cols)}
        for (i, j, a, kind, v) in reversed(info.singletons):
            rc = float(c[j] - _col_dot(A, j, y))
            if abs(rc) <= 1e-7 * max(1.0, abs(c[j])):
                continue  # interior or degenerate: this row's dual is 0
            t = pos.get(int(j))
            # value the variable landed on (reduced solution if it stayed,
            # the fixed value if a later reduction eliminated it)
            xv = x_unscaled[t] if t is not None else float(x[j])
            tol = 1e-6 * max(1.0, abs(xv))
            # binding = the optimum actually sits on THIS row's bound
            # (not a slack one that a tighter bound superseded)
            if kind == "fix":
                binding = abs(xv - v) <= tol
            elif kind == "up":
                binding = xv >= v - tol
            else:
                binding = xv <= v + tol
            if binding:
                y[i] = rc / a
    return x, y


# ---------------------------------------------------------------------------
# small dense/sparse helpers


def _col_dense(A, j) -> np.ndarray:
    if _issparse(A):
        return np.asarray(A[:, [int(j)]].todense(), np.float64).ravel()
    return np.asarray(A[:, j], np.float64)


def _col_dot(A, j, y) -> float:
    return float(np.dot(_col_dense(A, j), y))


def _matvec(A, x) -> np.ndarray:
    if _issparse(A):
        return np.asarray(A @ x, np.float64).ravel()
    return np.asarray(A, np.float64) @ x


def _geo_scale(W, axis: int) -> np.ndarray:
    """1/sqrt(max·min of |nonzeros|) along the given axis (rows: axis=1)."""
    if _issparse(W):
        Wa = abs(W).tocsr()
        Wa.eliminate_zeros()
        mx = np.asarray(Wa.max(axis=axis).todense()).ravel()
        # min over NONZEROS: invert nonzero data, take max
        Winv = Wa.copy()
        Winv.data = 1.0 / Winv.data
        mn_inv = np.asarray(Winv.max(axis=axis).todense()).ravel()
        mn = np.where(mn_inv > 0, 1.0 / np.where(mn_inv > 0, mn_inv, 1.0), 0.0)
    else:
        Wa = np.abs(W)
        mx = Wa.max(axis=axis)
        masked = np.where(Wa > 0, Wa, np.inf)
        mn = masked.min(axis=axis)
        mn = np.where(np.isfinite(mn), mn, 0.0)
    prod = mx * mn
    s = np.where(prod > 0, 1.0 / np.sqrt(prod), 1.0)
    return s


def _scale_rows(W, r):
    if _issparse(W):
        import scipy.sparse as sps

        return sps.diags(r) @ W
    return r[:, None] * W


def _scale_cols(W, s):
    if _issparse(W):
        import scipy.sparse as sps

        return W @ sps.diags(s)
    return W * s[None, :]
