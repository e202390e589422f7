"""HiGHS (through scipy) as the independent double-precision oracle."""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from simplex_tpu_torch.status import SolveStatus


class OracleResult(NamedTuple):
    z: Optional[float]
    x: Optional[np.ndarray]
    status: SolveStatus


def solve_scipy(A, b, c) -> OracleResult:
    """Solve max c.x s.t. Ax=b, x>=0 with scipy/HiGHS (minimizes, so negate)."""
    from scipy.optimize import linprog

    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    res = linprog(-c, A_eq=A, b_eq=b, bounds=(0, None), method="highs")
    if res.status == 0:
        return OracleResult(z=float(-res.fun), x=res.x, status=SolveStatus.OPTIMAL)
    if res.status == 3:
        return OracleResult(z=None, x=None, status=SolveStatus.UNBOUNDED)
    return OracleResult(z=None, x=None, status=SolveStatus.SINGULAR)


def solve_scipy_general(lp) -> OracleResult:
    """Solve a :class:`~simplex_tpu_torch.core.twophase.GeneralLP`
    (maximize, mixed row types, variable bounds) with scipy/HiGHS: the
    oracle of the two-phase route."""
    from scipy.optimize import linprog

    A = np.asarray(lp.A, np.float64)
    b = np.asarray(lp.b, np.float64)
    c = np.asarray(lp.c, np.float64)
    k = A.shape[1]
    types = [t.upper() for t in lp.row_types]
    sel_ub = [i for i, t in enumerate(types) if t == "L"]
    sel_lb = [i for i, t in enumerate(types) if t == "G"]
    sel_eq = [i for i, t in enumerate(types) if t == "E"]
    ineq = bool(sel_ub or sel_lb)
    A_ub = np.concatenate([A[sel_ub], -A[sel_lb]], axis=0) if ineq else None
    b_ub = np.concatenate([b[sel_ub], -b[sel_lb]]) if ineq else None
    A_eq = A[sel_eq] if sel_eq else None
    b_eq = b[sel_eq] if sel_eq else None
    lower = np.zeros(k) if lp.lower is None else np.asarray(lp.lower, np.float64)
    upper = np.full(k, np.inf) if lp.upper is None else np.asarray(lp.upper, np.float64)
    bounds = [
        (lo if np.isfinite(lo) else None, up if np.isfinite(up) else None)
        for lo, up in zip(lower, upper)
    ]
    res = linprog(
        -c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq, bounds=bounds, method="highs"
    )
    if res.status == 0:
        return OracleResult(z=float(-res.fun), x=res.x, status=SolveStatus.OPTIMAL)
    if res.status == 2:
        return OracleResult(z=None, x=None, status=SolveStatus.INFEASIBLE)
    if res.status == 3:
        return OracleResult(z=None, x=None, status=SolveStatus.UNBOUNDED)
    return OracleResult(z=None, x=None, status=SolveStatus.SINGULAR)


def relative_gap(z: float, z_ref: float) -> float:
    """|z - z_ref| / max(1, |z_ref|)."""
    return abs(z - z_ref) / max(1.0, abs(z_ref))
