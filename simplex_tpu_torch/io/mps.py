"""Minimal fixed/free-format MPS reader producing a dense LP.

A copy of ``simplex_tpu.io.mps`` for the port: that module needs no jax,
but importing it imports the jax package.

Supported sections: NAME, ROWS (N/L/G/E), COLUMNS (incl. RHS-style pairs),
RHS (incl. an objective-row constant), RANGES (expanded into a paired
opposite-direction row, GLPK semantics), BOUNDS (UP/LO/FX/FR/MI/PL/BV/LI/UI
on structural vars), OBJSENSE, ENDATA.

Integer markers (``MARKER 'INTORG'/'INTEND'``) and integer bound types
(BV/LI/UI) are accepted and RELAXED to continuous with a logged warning:
the LP relaxation, as ``glp_simplex`` solves a MIP deck. The integrality
mask is preserved on :class:`MPSProblem.integer` for callers that care.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclass
class MPSProblem:
    """A general-form LP as read from MPS: optimize c.x s.t. row constraints."""

    name: str
    maximize: bool  # MPS default is minimize
    row_names: List[str]  # constraint rows, in order (objective excluded)
    row_types: List[str]  # 'L' (<=), 'G' (>=), 'E' (=)
    col_names: List[str]
    A: np.ndarray  # (m, k) dense constraint matrix
    b: np.ndarray  # (m,) right-hand sides
    c: np.ndarray  # (k,) objective coefficients
    lower: np.ndarray  # (k,) variable lower bounds
    upper: np.ndarray  # (k,) variable upper bounds (inf = free above)
    # objective constant: true objective = c.x + c0 (MPS encodes it as an
    # RHS entry on the N row, with c0 = -rhs, matching GLPK)
    c0: float = 0.0
    # (k,) integrality mask from MARKER 'INTORG'/'INTEND' sections and
    # BV/LI/UI bound types, or None when the deck declares none. The solve
    # routes RELAX it (glp_simplex semantics — the LP relaxation); it is
    # kept so a caller can tell a relaxation from a true LP optimum.
    integer: Optional[np.ndarray] = None


def read_mps(path: str | os.PathLike, sparse: bool = False) -> MPSProblem:
    """Parse an MPS file. ``sparse=True`` stores ``A`` as a scipy.sparse
    csc matrix built straight from the COLUMNS triplets — the dense (m, k)
    array never materializes (netlib-class instances are >99% sparse; the
    round-2 review flagged the unconditional densification here). The
    port's ``solve_general`` takes such an A as it is and solves it sparse
    on the device."""
    with open(path, "r") as f:
        lines = f.readlines()

    section = None
    maximize = False
    name = ""
    obj_row: Optional[str] = None
    row_types: Dict[str, str] = {}
    row_order: List[str] = []
    col_order: List[str] = []
    col_entries: Dict[str, Dict[str, float]] = {}
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    bounds: Dict[str, Tuple[Optional[float], Optional[float]]] = {}
    explicit_lo: set = set()  # columns whose lower bound was set by LO/MI/FX
    int_cols: set = set()  # columns inside MARKER INTORG..INTEND / BV/LI/UI
    in_int_block = False

    def ensure_col(cn: str):
        if cn not in col_entries:
            col_entries[cn] = {}
            col_order.append(cn)

    i = 0
    while i < len(lines):
        raw = lines[i]
        i += 1
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        if not raw[0].isspace():
            parts = raw.split()
            section = parts[0].upper()
            if section == "NAME":
                name = parts[1] if len(parts) > 1 else ""
            elif section == "OBJSENSE":
                # sense may follow on the same or the next line
                if len(parts) > 1:
                    maximize = parts[1].upper().startswith("MAX")
                else:
                    maximize = lines[i].strip().upper().startswith("MAX")
                    i += 1
            elif section == "ENDATA":
                break
            continue

        parts = raw.split()
        if section == "ROWS":
            rtype, rname = parts[0].upper(), parts[1]
            if rtype == "N":
                if obj_row is None:
                    obj_row = rname
                # extra N rows are ignored (free rows), like GLPK
            elif rtype in ("L", "G", "E"):
                row_types[rname] = rtype
                row_order.append(rname)
            else:
                raise ValueError(f"unknown row type {rtype!r}")
        elif section == "COLUMNS":
            if any(
                p.upper() in ("'MARKER'", '"MARKER"') for p in parts[1:]
            ):
                # MARKER 'INTORG' opens / 'INTEND' closes an integer block;
                # columns inside are recorded and relaxed to continuous
                # (glp_simplex LP-relaxation semantics).
                # The keyword must be QUOTED, per the MPS format — an
                # unquoted MARKER here is a legitimate row name in a data
                # line and must not be swallowed.
                kinds = {p.strip("'\"").upper() for p in parts}
                if "INTORG" in kinds:
                    in_int_block = True
                elif "INTEND" in kinds:
                    in_int_block = False
                else:
                    raise ValueError(f"unknown MPS marker line: {raw!r}")
                continue
            cn = parts[0]
            ensure_col(cn)
            if in_int_block:
                int_cols.add(cn)
            for j in range(1, len(parts) - 1, 2):
                col_entries[cn][parts[j]] = float(parts[j + 1])
        elif section == "RHS":
            # first token is the RHS set name; pairs follow
            for j in range(1, len(parts) - 1, 2):
                rhs[parts[j]] = float(parts[j + 1])
        elif section == "RANGES":
            # first token is the range set name; (row, value) pairs follow
            for j in range(1, len(parts) - 1, 2):
                ranges[parts[j]] = float(parts[j + 1])
        elif section == "BOUNDS":
            btype = parts[0].upper()
            cn = parts[2]
            ensure_col(cn)
            lo, up = bounds.get(cn, (0.0, None))
            if btype == "UP":
                up = float(parts[3])
                # GLPK/CPLEX convention: a negative upper bound on a column
                # whose lower bound was never set explicitly implies
                # lower = -inf (otherwise the default 0 <= x <= up < 0 is
                # vacuously infeasible, which is never what the file means)
                if up < 0 and cn not in explicit_lo:
                    lo = None
            elif btype == "LO":
                lo = float(parts[3])
                explicit_lo.add(cn)
            elif btype == "FX":
                lo = up = float(parts[3])
                explicit_lo.add(cn)
            elif btype == "FR":
                lo, up = None, None
                explicit_lo.add(cn)
            elif btype == "MI":
                lo = None
                explicit_lo.add(cn)
            elif btype == "PL":
                up = None
            elif btype == "BV":
                # binary: relaxed to 0 <= x <= 1 (integrality recorded)
                lo, up = 0.0, 1.0
                explicit_lo.add(cn)
                int_cols.add(cn)
            elif btype == "LI":
                lo = float(parts[3])
                explicit_lo.add(cn)
                int_cols.add(cn)
            elif btype == "UI":
                up = float(parts[3])
                int_cols.add(cn)
            else:
                raise ValueError(f"unknown bound type {btype!r}")
            bounds[cn] = (lo, up)
        elif section in ("NAME", "OBJSENSE", None):
            continue
        else:
            raise ValueError(f"unexpected data line in section {section}: {raw!r}")

    if obj_row is None:
        raise ValueError("MPS file has no objective (N) row")

    m, k = len(row_order), len(col_order)
    c = np.zeros(k)
    row_pos = {rn: idx for idx, rn in enumerate(row_order)}
    if sparse:
        ii: List[int] = []
        jj: List[int] = []
        vv: List[float] = []
    else:
        A = np.zeros((m, k))
    for jcol, cn in enumerate(col_order):
        for rn, val in col_entries[cn].items():
            if rn == obj_row:
                c[jcol] = val
            elif rn in row_pos:
                if sparse:
                    ii.append(row_pos[rn])
                    jj.append(jcol)
                    vv.append(val)
                else:
                    A[row_pos[rn], jcol] = val
            # entries for ignored free rows are dropped
    if sparse:
        import scipy.sparse as sps

        A = sps.coo_matrix(
            (vv, (ii, jj)), shape=(m, k), dtype=np.float64
        ).tocsc()
    b = np.array([rhs.get(rn, 0.0) for rn in row_order])
    types = [row_types[rn] for rn in row_order]
    names = list(row_order)
    # objective constant: an RHS entry on the N row means obj = c.x - rhs
    c0 = -rhs.get(obj_row, 0.0)

    # RANGES: a ranged row i means  lb_i <= A_i x <= ub_i  (GLPK semantics:
    # L -> [b-|R|, b], G -> [b, b+|R|], E -> [b, b+R] for R>=0 else [b+R, b]).
    # Expand into the original row plus one opposite-direction row so the
    # downstream dense pipeline needs no interval-row concept.
    extra_rows = []  # (name, type, rhs, source row index)
    for i, rn in enumerate(row_order):
        if rn not in ranges:
            continue
        R = ranges[rn]
        t = types[i]
        if t == "L":
            extra_rows.append((rn + "__rlo", "G", b[i] - abs(R), i))
        elif t == "G":
            extra_rows.append((rn + "__rhi", "L", b[i] + abs(R), i))
        elif t == "E" and R != 0.0:
            lo, hi = (b[i], b[i] + R) if R > 0 else (b[i] + R, b[i])
            types[i] = "L"
            b[i] = hi
            extra_rows.append((rn + "__rlo", "G", lo, i))
    if extra_rows:
        if sparse:
            import scipy.sparse as sps

            A = sps.vstack(
                [A] + [A[src] for (_, _, _, src) in extra_rows],
                format="csc",
            )
        else:
            A = np.concatenate(
                [A, np.stack([A[src] for (_, _, _, src) in extra_rows])],
                axis=0,
            )
        b = np.concatenate([b, [v for (_, _, v, _) in extra_rows]])
        types += [t for (_, t, _, _) in extra_rows]
        names += [nm for (nm, _, _, _) in extra_rows]

    lower = np.zeros(k)
    upper = np.full(k, np.inf)
    for jcol, cn in enumerate(col_order):
        if cn in bounds:
            lo, up = bounds[cn]
            lower[jcol] = -np.inf if lo is None else lo
            upper[jcol] = np.inf if up is None else up
    integer = None
    if int_cols:
        integer = np.array([cn in int_cols for cn in col_order], bool)
        from simplex_tpu_torch.logging import get_logger

        get_logger("io.mps").warning(
            "%s: %d integer column(s) relaxed to continuous (LP relaxation"
            " — glp_simplex semantics); default bounds stay 0 <= x",
            name or os.fspath(path), int(integer.sum()),
        )
    return MPSProblem(
        name=name,
        maximize=maximize,
        row_names=names,
        row_types=types,
        col_names=col_order,
        A=A,
        b=b,
        c=c,
        lower=lower,
        upper=upper,
        c0=c0,
        integer=integer,
    )


def mps_to_canonical(prob: MPSProblem):
    """Convert an all-'L', b>=0, x>=0 MPS problem to canonical slack form.

    General rows/bounds route through
    :func:`simplex_tpu_torch.core.twophase.solve_general` instead.
    """
    from simplex_tpu_torch.io.canonical import from_inequalities

    if any(t != "L" for t in prob.row_types):
        raise ValueError(
            "mps_to_canonical handles only <= rows; use solve_general for "
            f"row types {sorted(set(prob.row_types))}"
        )
    if np.any(prob.lower != 0) or np.any(np.isfinite(prob.upper)):
        raise ValueError("mps_to_canonical requires default bounds 0 <= x")
    c = prob.c if prob.maximize else -prob.c
    return from_inequalities(prob.A, prob.b, c)
