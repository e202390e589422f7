"""Two-phase simplex for general-form LPs: ``simplex_tpu.core.twophase``
on the port's solver.

  Phase 1  maximize -(sum of artificials) from the artificial basis;
           optimum 0 iff the LP is feasible.
  Cleanup  drive basic-at-zero artificials out of the basis by a host-side
           pivot (or leave them pinned at zero for redundant rows).
  Phase 2  re-solve with the true objective from the phase-1 basis,
           artificials blocked by a large negative cost.

Both phases run :func:`simplex_tpu_torch.core.solver.solve` on ``device``;
finite upper bounds go to it as native bounds (``u=``), so a bound costs
no row. Bound rewriting, standardization and the artificial driveout are
host code on a float64 scipy CSC copy of A, whatever A's storage. A
warm-start token (``warm=``) skips phase 1: the dual simplex
(:func:`simplex_tpu_torch.core.dual.solve_dual`) re-solves from the stored
basis. ``lp.A`` may be scipy.sparse: the solver then takes the standardized
matrix as a sparse A, so dense A never exists; a dense ``lp.A`` gives the
solver a dense standardized A.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import scipy.sparse as sps
import torch

from simplex_tpu_torch.config import DEFAULT_OPTIONS, SimplexOptions
from simplex_tpu_torch.core.solver import solve
from simplex_tpu_torch.sparse import is_sparse as _issparse
from simplex_tpu_torch.logging import fields, get_logger
from simplex_tpu_torch.status import SolveStatus

_log = get_logger("twophase")


def _shape(A):
    """(m, k) for dense array-likes and scipy.sparse alike."""
    return A.shape if _issparse(A) else np.asarray(A).shape


def _csc64(A) -> sps.csc_matrix:
    """A float64 CSC copy of a dense or scipy.sparse A, duplicates summed."""
    A = sps.csc_matrix(A if _issparse(A) else np.asarray(A, np.float64), dtype=np.float64, copy=True)
    A.sum_duplicates()
    return A


def _colv(A: sps.csc_matrix, j) -> np.ndarray:
    """Column j of a CSC A as a dense float64 vector."""
    v = np.zeros(A.shape[0])
    lo, hi = A.indptr[int(j)], A.indptr[int(j) + 1]
    v[A.indices[lo:hi]] = A.data[lo:hi]
    return v


class GeneralLP(NamedTuple):
    """maximize c.x  s.t.  row_i: A_i x (<= | >= | ==) b_i,  lo <= x <= up.

    ``lower``/``upper`` default to 0 <= x; finite uppers, shifted lowers
    and free variables are rewritten to that domain by
    :func:`_preprocess_bounds` before the device solver sees them.
    """

    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    row_types: Sequence[str]  # 'L', 'G', or 'E' per row
    lower: Optional[np.ndarray] = None  # (k,) default 0; -inf = free below
    upper: Optional[np.ndarray] = None  # (k,) default +inf


class GeneralWarmStart(NamedTuple):
    """Warm-start token of an OPTIMAL :func:`solve_general` result, in the
    standardized column space: the optimal basis, its at-upper flags and
    the row flips of the standardization (which depend on sign(b), so a
    re-solve with a new b must reuse them)."""

    basis: np.ndarray  # (m,) standardized-space basis of the optimal point
    at_upper: Optional[np.ndarray]  # (n_std,) or None
    flips: np.ndarray  # (m,) +-1 row normalization of the original solve


class GeneralSolveResult(NamedTuple):
    z: float
    x: np.ndarray  # (k,) structural variables only
    status: SolveStatus
    iters: int  # total pivots across both phases
    phase1_iters: int
    # dual values for the ORIGINAL rows (maximization sense; sign-corrected
    # for rows the standardization negated). None on non-OPTIMAL exits.
    y: Optional[np.ndarray] = None
    # warm-start token (OPTIMAL exits only)
    warm: Optional[GeneralWarmStart] = None


def _preprocess_bounds(lp: GeneralLP):
    """Rewrite a bounded LP over the canonical domain x' >= 0:

      lo <= x <= up, lo finite   ->  x = x' + lo,   0 <= x' (<= up - lo)
      -inf <= x <= up, up finite ->  x = up - x',   0 <= x'
      free                       ->  x = x+ - x-,   both >= 0
      lo == up                   ->  substituted out entirely

    Residual finite uppers (up - lo after a shift) stay a native upper
    bound vector ``lp2.upper`` for the bounded-variable rule, not rows.

    Returns ``(lp2, recover, z_const)`` where ``recover`` maps the
    transformed solution back to the original variables and ``z_const``
    satisfies ``c.x == c2.x' + z_const``; or ``(None, None, None)`` when
    some lo > up (trivially infeasible). ``lp2.A`` is a float64 CSC matrix.
    """
    A = _csc64(lp.A)
    m, k = A.shape
    lower = np.zeros(k) if lp.lower is None else np.asarray(lp.lower, np.float64)
    upper = np.full(k, np.inf) if lp.upper is None else np.asarray(lp.upper, np.float64)
    b = np.asarray(lp.b, np.float64).copy()
    c = np.asarray(lp.c, np.float64)

    if np.any(lower > upper + 1e-12):
        return None, None, None

    if np.all(lower == 0) and not np.any(np.isfinite(upper)):
        lp2 = GeneralLP(A=A, b=b, c=c, row_types=list(lp.row_types))
        return lp2, (lambda x: x), 0.0

    cols: List[int] = []  # source column of each new column
    signs: List[float] = []
    costs: List[float] = []
    ubs: List[float] = []  # residual native upper per new column (+inf = none)
    ops = []  # per original var: ('shift',i,lo) | ('reflect',i,up) | ('split',i,j) | ('fixed',v)
    z_const = 0.0
    for j in range(k):
        lo, up = lower[j], upper[j]
        if np.isfinite(lo) and np.isfinite(up) and up - lo <= 1e-12:
            # fixed variable: substitute out
            if lo != 0.0:
                b -= _colv(A, j) * lo
            z_const += c[j] * lo
            ops.append(("fixed", lo))
        elif np.isfinite(lo):
            if lo != 0.0:
                b -= _colv(A, j) * lo
                z_const += c[j] * lo
            ops.append(("shift", len(cols), lo))
            cols.append(j)
            signs.append(1.0)
            costs.append(c[j])
            ubs.append(up - lo if np.isfinite(up) else np.inf)
        elif np.isfinite(up):
            # free below, bounded above: reflect  x = up - x'
            b -= _colv(A, j) * up
            z_const += c[j] * up
            ops.append(("reflect", len(cols), up))
            cols.append(j)
            signs.append(-1.0)
            costs.append(-c[j])
            ubs.append(np.inf)
        else:
            # free: split  x = x+ - x-
            ops.append(("split", len(cols), len(cols) + 1))
            cols += [j, j]
            signs += [1.0, -1.0]
            costs += [c[j], -c[j]]
            ubs += [np.inf, np.inf]

    k2 = len(cols)
    A2 = (A[:, cols] @ sps.diags(signs, shape=(k2, k2))).tocsc()
    u2 = np.asarray(ubs) if ubs else np.full(k2, np.inf)
    if not np.any(np.isfinite(u2)):
        u2 = None  # classic domain: the unbounded path

    def recover(xp: np.ndarray) -> np.ndarray:
        x = np.empty(k, xp.dtype if xp.dtype.kind == "f" else np.float64)
        for j, op in enumerate(ops):
            if op[0] == "fixed":
                x[j] = op[1]
            elif op[0] == "shift":
                x[j] = xp[op[1]] + op[2]
            elif op[0] == "reflect":
                x[j] = op[2] - xp[op[1]]
            else:  # split
                x[j] = xp[op[1]] - xp[op[2]]
        return x

    lp2 = GeneralLP(A=A2, b=b, c=np.asarray(costs), row_types=list(lp.row_types), upper=u2)
    return lp2, recover, z_const


def _standardize(lp: GeneralLP, flips_override=None):
    """Equality form with slacks/surpluses and artificial columns.

    Returns (A_std, b_std, c_std (phase-2 costs), k_struct, n_real,
    artificial column indices, phase-1 basis, row sign flips, u_std).
    Rows with b < 0 are negated (L <-> G). ``u_std`` is the native
    upper-bound vector over all standardized columns (structural residual
    uppers from ``lp.upper``; slacks and artificials unbounded), or None
    when every upper is infinite. ``flips_override`` (warm restarts)
    reproduces a previous solve's row flips instead of taking them from
    sign(b): the column layout must match the stored basis, and the dual
    warm start does not need b >= 0. A_std is a float64 CSC matrix.
    """
    A = _csc64(lp.A)
    b = np.asarray(lp.b, np.float64).copy()
    c = np.asarray(lp.c, np.float64)
    m, k = A.shape
    if len(lp.row_types) != m:
        raise ValueError("row_types length != m")

    types = []
    flips = np.ones(m)
    for i, t in enumerate(lp.row_types):
        t = t.upper()
        if t not in ("L", "G", "E"):
            raise ValueError(f"bad row type {t!r}")
        if (flips_override[i] < 0) if flips_override is not None else (b[i] < 0):
            b[i] *= -1
            t = {"L": "G", "G": "L", "E": "E"}[t]
            flips[i] = -1.0
        types.append(t)
    if np.any(flips < 0):
        # one diagonal scale (CSC rows are not writable slices)
        A = (sps.diags(flips) @ A).tocsc()

    slack_cols = [(i, 1.0 if t == "L" else -1.0) for i, t in enumerate(types) if t != "E"]
    # a +1 slack can start basic; every other row gets an artificial
    basis_from_slack = {i: k + j for j, (i, sgn) in enumerate(slack_cols) if sgn > 0}
    art_rows = [i for i in range(m) if i not in basis_from_slack]

    S = sps.csc_matrix(
        ([sgn for _, sgn in slack_cols], ([i for i, _ in slack_cols], np.arange(len(slack_cols)))),
        shape=(m, len(slack_cols)),
    )
    R = sps.csc_matrix(
        (np.ones(len(art_rows)), (art_rows, np.arange(len(art_rows)))),
        shape=(m, len(art_rows)),
    )
    A_std = sps.hstack([A, S, R], format="csc")
    n_real = k + S.shape[1]
    art_cols = np.arange(n_real, n_real + len(art_rows), dtype=np.int32)
    basis1 = np.empty(m, np.int32)
    for i, j in basis_from_slack.items():
        basis1[i] = j
    basis1[art_rows] = art_cols
    u_std = None
    if lp.upper is not None and np.any(np.isfinite(lp.upper)):
        u_std = np.concatenate(
            [np.asarray(lp.upper, np.float64), np.full(A_std.shape[1] - k, np.inf)]
        )
    return A_std, b, c, k, n_real, art_cols, basis1, flips, u_std


def _drive_out_artificials(A_std, basis, art_set, tol=1e-7, at_upper=None):
    """Replace basic artificials (at value ~0) with non-artificial columns.

    Host-side: for each basic artificial in row r, the non-artificial,
    nonbasic column j with the largest |(B_inv A)_{r,j}| swaps in (the
    classic phase-1 cleanup, max-magnitude for stability). A row with no
    eligible column is redundant; its artificial stays basic, pinned at
    zero by the phase-2 cost. Columns parked at their upper bound
    (``at_upper``) are excluded: only value-0 columns enter, so every swap
    stays degenerate. One O(m^3) inversion, then one O(mn) row product and
    one rank-1 update per basic artificial. ``A_std`` may be dense or
    scipy.sparse; the driveout reads a float64 CSC copy.
    """
    A_std = _csc64(A_std)
    basis = basis.copy()
    m, n = A_std.shape
    art_rows = [r for r in range(m) if basis[r] in art_set]
    if not art_rows:
        return basis
    blocked = np.zeros(n, bool)  # basic or artificial columns
    blocked[list(art_set)] = True
    blocked[basis] = True
    if at_upper is not None:
        blocked |= np.asarray(at_upper, bool)
    B_inv = np.linalg.inv(A_std[:, basis].toarray())
    for r in art_rows:
        # vec @ CSC is a dense (n,) ndarray
        row = np.abs(np.asarray(B_inv[r] @ A_std).ravel())
        row[blocked] = 0.0
        j = int(np.argmax(row))
        if row[j] <= tol:
            continue  # redundant row
        blocked[int(basis[r])] = True  # stays blocked (artificial)
        blocked[j] = True
        basis[r] = j
        # product-form update: B_inv <- E B_inv, eta of the entering column
        alpha = B_inv @ _colv(A_std, j)
        eta = -alpha / alpha[r]
        eta[r] = 1.0 / alpha[r] - 1.0
        B_inv = B_inv + np.outer(eta, B_inv[r])
    return basis


def solve_general(
    lp: GeneralLP,
    *,
    options: SimplexOptions = DEFAULT_OPTIONS,
    phase2_artificial_cost: Optional[float] = None,
    warm: Optional[GeneralWarmStart] = None,
    presolve: bool = False,
    device="cuda",
) -> GeneralSolveResult:
    """Solve a general-form LP by two-phase simplex on ``device`` (default
    ``"cuda"``; there is no fallback to the CPU).

    Variable bounds (``lp.lower``/``lp.upper``) are honored: the LP is
    rewritten over x' >= 0 by :func:`_preprocess_bounds`, residual finite
    uppers go to the solver as native bounds, and the solution is mapped
    back. ``presolve=True`` first runs :mod:`simplex_tpu_torch.presolve`
    and maps the primal and dual solutions back through postsolve (no warm
    token then, and ``warm`` cannot be combined with it: the token's basis
    lives in the unreduced column space). An OPTIMAL result carries a
    ``warm`` token; passed back as ``warm=`` on the same A / c / row_types /
    bounds with another b, it skips phase 1: the standardization repeats the
    original row flips and the dual simplex re-solves from the stored basis.
    ``lp.A`` may be scipy.sparse (see the module docstring).
    """
    if presolve:
        if warm is not None:
            raise ValueError(
                "warm restarts cannot be combined with presolve=True: the warm "
                "token's basis lives in the unreduced column space. Re-solve "
                "cold with presolve, or warm-solve with presolve=False."
            )
        return _solve_general_presolved(
            lp, options=options, phase2_artificial_cost=phase2_artificial_cost,
            device=device,
        )
    m_orig, k_orig = _shape(lp.A)
    sparse_in = _issparse(lp.A)
    lp, recover, z_const = _preprocess_bounds(lp)
    if lp is None:  # some lower bound exceeds its upper bound
        return GeneralSolveResult(
            z=float("nan"), x=np.zeros(k_orig), status=SolveStatus.INFEASIBLE,
            iters=0, phase1_iters=0,
        )
    A_csc, b, c, k, n_real, art_cols, basis1, flips, u_std = _standardize(
        lp, flips_override=None if warm is None else np.asarray(warm.flips)
    )
    # the device solves take A as the caller stored it
    A_std = A_csc if sparse_in else A_csc.toarray()
    m, n = A_std.shape
    art_set = set(art_cols.tolist())

    p1_iters = 0
    basis = basis1
    at_upper = None  # threaded through the phases when u_std is not None
    if warm is not None:
        basis = np.asarray(warm.basis, np.int32)
        if basis.shape != (m,) or int(basis.max(initial=0)) >= n:
            raise ValueError(
                "warm token does not match this instance's standardized "
                f"shape (basis {basis.shape}, max {basis.max(initial=0)} "
                f"vs m={m}, n={n}): the warm path requires the same "
                "A / c / row_types / bounds, only b may change"
            )
        if warm.at_upper is not None:
            at_upper = np.asarray(warm.at_upper, bool)
        elif u_std is not None:
            at_upper = np.zeros(n, bool)
    elif len(art_cols) > 0:
        # Phase 1: max -(sum of artificials)
        c1 = np.zeros(n)
        c1[art_cols] = -1.0
        r1 = solve(A_std, b, c1, basis0=basis1, u=u_std, options=options, device=device)
        p1_iters = r1.iters
        if r1.status != SolveStatus.OPTIMAL:
            return GeneralSolveResult(
                z=float("nan"), x=np.zeros(k_orig), status=r1.status,
                iters=p1_iters, phase1_iters=p1_iters,
            )
        # options.dtype is a torch dtype here (the reference compares
        # against np.float32)
        feas_tol = 1e-5 if options.dtype == torch.float32 else 1e-8
        if r1.z < -feas_tol * max(1.0, abs(b).max()):
            # the artificials cannot all reach zero: no feasible point
            return GeneralSolveResult(
                z=float("nan"), x=np.zeros(k_orig), status=SolveStatus.INFEASIBLE,
                iters=p1_iters, phase1_iters=p1_iters,
            )
        _log.info("phase 1 complete", extra=fields(iters=p1_iters, z1=float(r1.z)))
        at_upper = r1.at_upper
        basis = _drive_out_artificials(A_csc, r1.basis, art_set, at_upper=at_upper)

    # Phase 2: true objective; artificials blocked by a large negative cost,
    # except those still basic after the driveout (redundant rows): they
    # can never leave, and a big cost on a basic column would leak into
    # that row's dual, so they cost 0 and sit at 0.
    c2 = np.zeros(n)
    c2[:k] = c
    big = phase2_artificial_cost
    if big is None:
        big = -1e4 * max(1.0, float(np.abs(c).max()))
    iters2 = 0
    art_tol = 1e-5 * max(1.0, float(np.abs(b).max()))
    for _attempt in range(3):
        # the pinned set comes from the current basis on every retry, so an
        # artificial that re-entered elsewhere gets the escalated penalty
        pinned = np.asarray([a for a in basis.tolist() if a in art_set], np.int32)
        if len(art_cols) > 0:
            c2[art_cols] = big
            if len(pinned) > 0:
                c2[pinned] = 0.0
        if warm is not None and _attempt == 0:
            # the stored basis is dual-feasible for c2 (it was optimal for
            # the same costs) but primal-infeasible under the new b: the
            # dual simplex's entry contract. Nonbasic artificials are FIXED
            # at 0 (upper bound 0), so the dual loop proves infeasibility
            # over the real columns instead of parking residual on a big-M
            # artificial. A penalty retry starts from ITS basis, which is
            # primal-feasible, and runs the primal loop as usual.
            from simplex_tpu_torch.core.dual import solve_dual

            u_warm, at_up_warm = u_std, at_upper
            in_basis = set(basis.tolist())
            free_arts = [a for a in art_cols.tolist() if a not in in_basis]
            if free_arts:
                u_warm = np.full(n, np.inf) if u_std is None else u_std.copy()
                u_warm[np.asarray(free_arts)] = 0.0
                if at_up_warm is None:
                    at_up_warm = np.zeros(n, bool)
            r2 = solve_dual(
                A_std, b, c2, basis0=basis, u=u_warm, at_upper0=at_up_warm,
                options=options, device=device,
            )
            if r2.status == SolveStatus.INFEASIBLE:
                return GeneralSolveResult(
                    z=float("nan"), x=np.zeros(k_orig), status=SolveStatus.INFEASIBLE,
                    iters=r2.iters, phase1_iters=0,
                )
        else:
            r2 = solve(
                A_std, b, c2, basis0=basis, u=u_std, at_upper0=at_upper,
                options=options, device=device,
            )
        iters2 += r2.iters
        # an artificial re-entering at a nonzero value means the penalty was
        # too small for this problem's duals: escalate and re-solve from
        # the same basis instead of reporting it as OPTIMAL
        art_resid = float(np.abs(r2.x[art_cols]).max()) if len(art_cols) else 0.0
        if art_resid <= art_tol or r2.status != SolveStatus.OPTIMAL:
            break
        _log.warning(
            "artificial re-entered at nonzero value; escalating penalty",
            extra=fields(resid=art_resid, penalty=big * 1e3),
        )
        big *= 1e3
        basis = r2.basis
        at_upper = r2.at_upper
    status = r2.status
    if status == SolveStatus.OPTIMAL and art_resid > art_tol:
        status = SolveStatus.SINGULAR  # could not pin the artificials at 0
    x = recover(r2.x[:k])
    z = float(np.dot(c, r2.x[:k])) + z_const
    # duals of the caller's rows, with the sign of negated rows flipped
    # back; the column transforms do not change row duals
    y = None
    warm_out = None
    if status == SolveStatus.OPTIMAL:
        y = (np.asarray(r2.y[: len(flips)], np.float64) * flips)[:m_orig]
        warm_out = GeneralWarmStart(
            basis=np.asarray(r2.basis, np.int32),
            at_upper=None if r2.at_upper is None else np.asarray(r2.at_upper, bool),
            flips=np.asarray(flips),
        )
    return GeneralSolveResult(
        z=z, x=x, status=status, iters=p1_iters + iters2, phase1_iters=p1_iters,
        y=y, warm=warm_out,
    )


def _solve_general_presolved(
    lp: GeneralLP,
    *,
    options: SimplexOptions,
    phase2_artificial_cost: Optional[float],
    device,
) -> GeneralSolveResult:
    """presolve -> solve_general on the reduced LP -> postsolve (see
    :mod:`simplex_tpu_torch.presolve` for the reductions)."""
    from simplex_tpu_torch.presolve import postsolve
    from simplex_tpu_torch.presolve import presolve as run_presolve

    m_orig, k_orig = _shape(lp.A)
    c_orig = np.asarray(lp.c, np.float64)
    pr = run_presolve(lp)
    if pr.status is not None and pr.status != SolveStatus.OPTIMAL:
        return GeneralSolveResult(
            z=float("nan"), x=np.zeros(k_orig), status=pr.status,
            iters=0, phase1_iters=0,
        )
    if pr.lp is None:
        # presolve decided everything on the host (OPTIMAL)
        x, y = postsolve(pr.info, lp.A, c_orig, np.zeros(0), np.zeros(0))
        return GeneralSolveResult(
            z=pr.z, x=x, status=SolveStatus.OPTIMAL, iters=0, phase1_iters=0, y=y,
        )
    res = solve_general(
        pr.lp, options=options, phase2_artificial_cost=phase2_artificial_cost,
        device=device,
    )
    if res.status != SolveStatus.OPTIMAL:
        return GeneralSolveResult(
            z=res.z, x=np.zeros(k_orig), status=res.status,
            iters=res.iters, phase1_iters=res.phase1_iters,
        )
    x, y = postsolve(pr.info, lp.A, c_orig, res.x, res.y)
    return GeneralSolveResult(
        z=float(np.dot(c_orig, x)), x=x, status=res.status, iters=res.iters,
        phase1_iters=res.phase1_iters, y=y,
    )
