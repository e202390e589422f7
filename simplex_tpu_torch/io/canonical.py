"""Canonicalization: general LPs into the solver's canonical form.

A copy of ``simplex_tpu.io.canonical`` for the port (numpy only), without
its TPU padding helpers (``pad_columns`` / ``pad_rows``): the Hopper
kernels take any shape.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class CanonicalLP(NamedTuple):
    A: np.ndarray  # (m, n) with A[:, basis0] = I
    b: np.ndarray  # (m,)  >= 0
    c: np.ndarray  # (n,)
    basis0: np.ndarray  # (m,) int32 — feasible starting basis (slack block)
    n_structural: int  # columns of the original problem (prefix of A)


def from_inequalities(A_ub, b_ub, c) -> CanonicalLP:
    """max c.x  s.t.  A_ub x <= b_ub, x >= 0  ->  canonical form with slacks.

    Requires b_ub >= 0, so that the slack basis is feasible; general
    right-hand sides go through
    :func:`simplex_tpu_torch.core.twophase.solve_general`.
    """
    A_ub = np.asarray(A_ub, np.float64)
    b_ub = np.asarray(b_ub, np.float64)
    c = np.asarray(c, np.float64)
    m, k = A_ub.shape
    if np.any(b_ub < 0):
        raise ValueError(
            "b must be nonnegative for a feasible slack basis (use "
            "solve_general for general right-hand sides)"
        )
    A = np.concatenate([A_ub, np.eye(m)], axis=1)
    c_full = np.concatenate([c, np.zeros(m)])
    basis0 = np.arange(k, k + m, dtype=np.int32)
    return CanonicalLP(A, b_ub.copy(), c_full, basis0, k)


class EqualityForm(NamedTuple):
    """Box-bounded equality form of a GeneralLP:
    max c.x  s.t.  A x = b,  0 <= x <= u.

    ``recover`` maps the k2 TRANSFORMED structural variables (the first k2
    columns of A, before the slack block) back to the caller's original
    variables; ``z_const`` satisfies  z_original = z_transformed + z_const
    (nonzero when lower bounds were shifted / reflected / substituted)."""

    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    u: np.ndarray
    k_transformed: int  # structural (pre-slack) columns of A
    recover: object  # callable (k_transformed,) -> original (k,)
    z_const: float


def to_equality_form(lp) -> EqualityForm:
    """GeneralLP -> box-bounded equality form (see :class:`EqualityForm`).

    The same shift / reflect / split rewriting of the bounds as the
    two-phase route (``twophase._preprocess_bounds``): shifted lowers,
    finite uppers (kept as native box bounds), free-below columns
    (reflected), free columns (split into x+ - x-) and fixed columns
    (substituted out). L rows then gain a +slack column, G rows a -surplus
    column (both unbounded above), E rows nothing. Dense A only.

    Raises ``ValueError`` on a trivially infeasible bound pair (lo > up).
    """
    from simplex_tpu_torch.core.twophase import GeneralLP, _preprocess_bounds

    if not isinstance(lp, GeneralLP):
        lp = GeneralLP(*lp)
    lp2, recover, z_const = _preprocess_bounds(lp)
    if lp2 is None:
        raise ValueError("infeasible bounds: some lower exceeds its upper")
    A = lp2.A.toarray()  # float64 CSC from the rewriting
    b = np.asarray(lp2.b, np.float64)
    c = np.asarray(lp2.c, np.float64)
    m, k2 = A.shape
    upper = (
        np.full(k2, np.inf)
        if lp2.upper is None
        else np.asarray(lp2.upper, np.float64)
    )
    types = [t.upper() for t in lp2.row_types]
    aug = [i for i, t in enumerate(types) if t in ("L", "G")]
    S = np.zeros((m, len(aug)))
    for j, i in enumerate(aug):
        S[i, j] = 1.0 if types[i] == "L" else -1.0
    A_eq = np.concatenate([A, S], axis=1)
    c_eq = np.concatenate([c, np.zeros(len(aug))])
    u_eq = np.concatenate([upper, np.full(len(aug), np.inf)])
    return EqualityForm(
        A=A_eq, b=b, c=c_eq, u=u_eq, k_transformed=k2, recover=recover,
        z_const=float(z_const),
    )
