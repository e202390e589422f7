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


def relative_gap(z: float, z_ref: float) -> float:
    """|z - z_ref| / max(1, |z_ref|)."""
    return abs(z - z_ref) / max(1.0, abs(z_ref))
