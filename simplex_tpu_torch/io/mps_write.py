"""MPS writer — the inverse of :mod:`simplex_tpu_torch.io.mps`.

A copy of ``simplex_tpu.io.mps_write`` for the port (numpy only).

Writes fixed-format MPS (for cross-checking with external solvers,
archiving a generated instance, or shipping a repro) covering the feature
set the reader supports: N/L/G/E rows, RHS (incl. an objective constant),
BOUNDS (UP/LO/FX/FR/MI), and OBJSENSE.

Round-trip guarantee: ``read_mps(write_mps(path, ...))`` reproduces A, b,
c, row types, bounds, sense, and c0 exactly (values are printed with
``repr``-faithful %.17g).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

import numpy as np


def _fmt(v: float) -> str:
    return f"{float(v):.17g}"


def write_mps(
    path: str | os.PathLike,
    A,
    b,
    c,
    row_types: Sequence[str],
    *,
    name: str = "SIMPLEXTPU",
    maximize: bool = False,
    lower: Optional[np.ndarray] = None,
    upper: Optional[np.ndarray] = None,
    c0: float = 0.0,
    row_names: Optional[Sequence[str]] = None,
    col_names: Optional[Sequence[str]] = None,
) -> None:
    """Write a general-form LP (optimize c.x s.t. row constraints, bounds)
    as fixed-format MPS. Zero entries of A are omitted (MPS is sparse)."""
    A = np.asarray(A, np.float64)
    b = np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    m, k = A.shape
    if len(row_types) != m:
        raise ValueError("row_types length != m")
    rn = list(row_names) if row_names is not None else [f"R{i}" for i in range(m)]
    cn = list(col_names) if col_names is not None else [f"X{j}" for j in range(k)]
    lo = np.zeros(k) if lower is None else np.asarray(lower, np.float64)
    up = np.full(k, np.inf) if upper is None else np.asarray(upper, np.float64)

    lines = [f"NAME          {name}"]
    if maximize:
        lines += ["OBJSENSE", "    MAX"]
    lines.append("ROWS")
    lines.append(" N  OBJ")
    for i, t in enumerate(row_types):
        t = t.upper()
        if t not in ("L", "G", "E"):
            raise ValueError(f"bad row type {t!r}")
        lines.append(f" {t}  {rn[i]}")
    lines.append("COLUMNS")
    for j in range(k):
        entries = []
        if c[j] != 0.0:
            entries.append(("OBJ", c[j]))
        for i in range(m):
            if A[i, j] != 0.0:
                entries.append((rn[i], A[i, j]))
        for s in range(0, len(entries), 2):
            pair = entries[s : s + 2]
            parts = "   ".join(f"{r:<10}{_fmt(v):>15}" for r, v in pair)
            lines.append(f"    {cn[j]:<10}{parts}")
        if not entries:
            # a column with no coefficients still needs to exist
            lines.append(f"    {cn[j]:<10}OBJ       {_fmt(0.0):>15}")
    lines.append("RHS")
    for i in range(m):
        if b[i] != 0.0:
            lines.append(f"    RHS       {rn[i]:<10}{_fmt(b[i]):>15}")
    if c0 != 0.0:
        # GLPK convention: objective constant = -RHS of the N row
        lines.append(f"    RHS       {'OBJ':<10}{_fmt(-c0):>15}")
    bound_lines = []
    for j in range(k):
        l_j, u_j = lo[j], up[j]
        if l_j == 0.0 and not np.isfinite(u_j) and u_j > 0:
            continue  # default bound
        if not np.isfinite(l_j) and not np.isfinite(u_j):
            bound_lines.append(f" FR BND       {cn[j]}")
            continue
        if np.isfinite(l_j) and l_j == u_j:
            bound_lines.append(f" FX BND       {cn[j]:<10}{_fmt(l_j):>15}")
            continue
        if not np.isfinite(l_j):
            bound_lines.append(f" MI BND       {cn[j]}")
        elif l_j != 0.0 or (np.isfinite(u_j) and u_j < 0):
            # the explicit LO line is mandatory when lo == 0 but up < 0:
            # readers following the negative-UP convention (io/mps.py) would
            # otherwise rewrite the implicit 0 lower to -inf, silently
            # round-tripping the (crossed) [0, u<0] into a feasible
            # [-inf, u]
            bound_lines.append(f" LO BND       {cn[j]:<10}{_fmt(l_j):>15}")
        if np.isfinite(u_j):
            bound_lines.append(f" UP BND       {cn[j]:<10}{_fmt(u_j):>15}")
    if bound_lines:
        lines.append("BOUNDS")
        lines += bound_lines
    lines.append("ENDATA")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
