"""Plain PyTorch versions of the solver's hot ops.

The counterpart of ``simplex_tpu.kernels.xla``: the same functions with the
same contracts, written as ordinary torch ops that run on any device. The
``"torch"`` backend runs the pivot step on these alone; the ``"hopper"``
backend replaces pricing, the ratio test and the B_inv update with the CUDA
kernels of :mod:`simplex_tpu_torch.kernels.hopper`, which hold themselves
against these functions.

Every index a later op needs stays a device tensor: columns and rows are
picked with ``index_select`` (never ``t[p]`` with a tensor ``p``, which would
read ``p`` back to the host), so a pivot step runs without a host sync.

The ops that read A take a dense tensor or a
:class:`simplex_tpu_torch.sparse.SparseA` (``reduced_costs`` and so both
``choose_entering`` rules, ``pricing_update(2)``, the column gathers,
``gather_basis_matrix``, ``matvec``), as ``kernels.xla`` takes a
``BlockSparse``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.status import SolveStatus

INT_MAX = 2**31 - 1
BASIC_PENALTY = 1e30


def reduced_costs(y: torch.Tensor, A: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """e_j = y . A_j - c_j, accumulated in c's dtype (A may be a bf16 shadow,
    which is upcast; or sparse: one SpMV over A^T)."""
    if isinstance(A, _sp.SparseA):
        return _sp.rmatvec(A, y).to(c.dtype) - c
    return y.to(c.dtype) @ A.to(c.dtype) - c


def choose_entering(
    y: torch.Tensor,
    A: torch.Tensor,
    c: torch.Tensor,
    eps: float,
    use_bland: torch.Tensor,
    basis: Optional[torch.Tensor] = None,
    base_col: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entering column ``(p, min_e)``: the lowest-index argmin of e (Dantzig),
    or under Bland's rule the first j with e_j < -eps (0 when none; the
    caller's optimality test ``min_e >= -eps`` fires first then).

    Given ``basis`` (global column indices), the basic columns get
    +BASIC_PENALTY, so a drifted basic reduced cost can never win and the
    optimality test ranges over nonbasic columns. A and c may be a column
    segment that starts at global column ``base_col``; ``p`` comes out
    global (local index + ``base_col``)."""
    e = reduced_costs(y, A, c)
    if basis is not None:
        e = add_basic_penalty(e, basis, base_col)
    p_dantzig = torch.argmin(e)
    # argmax over a 0/1 vector = first 1 (torch.argmax returns the first max)
    p_bland = torch.argmax((e < -eps).to(torch.int32))
    p = torch.where(use_bland.view(()).to(torch.bool), p_bland, p_dantzig)
    if base_col:
        p = p + base_col
    return p.to(torch.int32), e.min()


def add_basic_penalty(s: torch.Tensor, basis: torch.Tensor, lo: int = 0) -> torch.Tensor:
    """s + BASIC_PENALTY at the basic columns that fall in the column range
    [lo, lo + len(s)) that s covers."""
    w = s.shape[0]
    loc = (basis - lo).clamp(0, w - 1)
    pen = torch.where((basis >= lo) & (basis < lo + w), BASIC_PENALTY, 0.0)
    return s.index_add(0, loc, pen.to(s.dtype))


def choose_entering_bounded(
    y: torch.Tensor,
    A: torch.Tensor,
    c: torch.Tensor,
    at_upper: torch.Tensor,
    basis: torch.Tensor,
    base_col: int,
    eps: float,
    use_bland: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entering column under the bounded-variable rule: ``(p, min_s)`` over
    the signed reduced costs s_j = at_upper_j ? -e_j : e_j (an at-upper
    column improves by decreasing). Basic columns get +BASIC_PENALTY after
    the sign flip. A, c and at_upper may be a column segment starting at
    global column ``base_col``; ``basis`` is global, and so is ``p`` (the
    segment's local index + ``base_col``, where the JAX function returns the
    local index). Bland's rule takes the first s_j < -eps."""
    e = reduced_costs(y, A, c)
    s = add_basic_penalty(torch.where(at_upper, -e, e), basis, base_col)
    p_dantzig = torch.argmin(s)
    p_bland = torch.argmax((s < -eps).to(torch.int32))
    p = torch.where(use_bland, p_bland, p_dantzig)
    if base_col:
        p = p + base_col
    return p.to(torch.int32), s.min()


def devex_choose(
    e: torch.Tensor, gamma: torch.Tensor, eps: float, use_bland: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Entering column from the maintained reduced costs under devex or
    steepest-edge weights, ``(p, min_e)``: the lowest-index argmax of
    e_j^2 / gamma_j over the eligible columns (e_j < -eps), or under Bland's
    rule the first eligible column (0 when none; ``min_e >= -eps`` says so).
    Basic columns are not masked: a drifted pick is caught by the step's
    exact recheck."""
    neg = e < -eps
    score = torch.where(neg, (e * e) / gamma, -math.inf)
    p_bland = torch.argmax(neg.to(torch.int32))
    p = torch.where(use_bland.view(()).to(torch.bool), p_bland, torch.argmax(score))
    return p.to(torch.int32), e.min()


def devex_choose_bounded(
    e: torch.Tensor,
    gamma: torch.Tensor,
    at_upper: torch.Tensor,
    eps: float,
    use_bland: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`devex_choose` under the bounded-variable rule, ``(p, min_s)``:
    eligibility and the termination value take the signed reduced cost
    s_j = at_upper_j ? -e_j : e_j; the score e^2 / gamma is sign-free."""
    s = torch.where(at_upper, -e, e)
    neg = s < -eps
    score = torch.where(neg, (e * e) / gamma, -math.inf)
    p_bland = torch.argmax(neg.to(torch.int32))
    p = torch.where(use_bland.view(()).to(torch.bool), p_bland, torch.argmax(score))
    return p.to(torch.int32), s.min()


def pricing_update(A: torch.Tensor, rho: torch.Tensor) -> torch.Tensor:
    """w = rho . A, the updated pivot row of the tableau: one O(mn) pass in
    full fp32 (w feeds the incremental reduced costs and weights, whose
    error compounds over pivots). Sparse A: one SpMV over A^T."""
    if isinstance(A, _sp.SparseA):
        return _sp.rmatvec(A, rho).to(rho.dtype)
    return rho @ A.to(rho.dtype)


def pricing_update2(
    A: torch.Tensor, rho: torch.Tensor, u: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(rho . A, u . A)`` as one (2, m) x (m, n) product in full fp32, so
    that A is read once (steepest edge's pivot row and its weight
    recurrence's t_j . alpha terms). Sparse A: one SpMM over A^T."""
    if isinstance(A, _sp.SparseA):
        w, v = _sp.rmatvec2(A, rho, u)
        return w.to(rho.dtype), v.to(rho.dtype)
    wv = torch.stack([rho, u]) @ A.to(rho.dtype)
    return wv[0], wv[1]


def mask_basic(c: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """c - 1e30 at the basic columns, so a drifted basic reduced cost can
    never win pricing and the optimality test ranges over nonbasic columns."""
    penalty = torch.full(basis.shape, -BASIC_PENALTY, dtype=c.dtype, device=c.device)
    return c.index_add(0, basis, penalty)


def gather_column(A: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A[:, p] for a 0-d device index p (no host read, sparse A too)."""
    if isinstance(A, _sp.SparseA):
        return _sp.gather_column(A, p)
    return A.index_select(1, p.view(1)).view(-1)


def gather_cost(c: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """c[p] as a 0-d tensor."""
    return c.index_select(0, p.view(1)).view(())


def gather_column_cost(A: torch.Tensor, c: torch.Tensor, p: torch.Tensor):
    """``(A[:, p], c[p])``: the entering column and its cost."""
    return gather_column(A, p), gather_cost(c, p)


def gather_columns(A: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """A[:, idx] for a device index vector (the multiple-pricing refill)."""
    if isinstance(A, _sp.SparseA):
        return _sp.gather_columns(A, idx)
    return A.index_select(1, idx)


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(values, indices)`` of the k largest entries of x, largest first,
    indices int32. Exact: it stands for ``jax.lax.approx_max_k``, which the
    JAX package uses only to select multiple-pricing candidates (exact on
    the CPU, ~0.95 recall on a TPU); ties may come out in another order."""
    vals, idx = torch.topk(x, k)
    return vals, idx.to(torch.int32)


def gather_basis_matrix(A: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """A[:, basis], the basis matrix (dense, sparse A too)."""
    if isinstance(A, _sp.SparseA):
        return _sp.gather_columns(A, basis)
    return A.index_select(1, basis)


def matvec(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A @ x in x's dtype."""
    if isinstance(A, _sp.SparseA):
        return _sp.matvec(A, x).to(x.dtype)
    return A.to(x.dtype) @ x


def ratio_argmin(
    x_b: torch.Tensor,
    alpha: torch.Tensor,
    basis: torch.Tensor,
    pivot_tol: float,
    use_bland: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Classic masked ratio test ``(q, theta_q, unbounded)``: theta_i =
    max(x_b_i, 0) / alpha_i over alpha_i > pivot_tol, q its lowest-index
    argmin; under Bland's rule the smallest basis index among rows attaining
    the exact minimum."""
    mask = alpha > pivot_tol
    unbounded = ~mask.any()
    theta = torch.where(
        mask, x_b.clamp_min(0) / torch.where(mask, alpha, 1), math.inf
    )
    tmin = theta.min()
    q_plain = torch.argmin(theta)
    q_bland = torch.argmin(torch.where(theta == tmin, basis, INT_MAX))
    q = torch.where(use_bland, q_bland, q_plain).to(torch.int32)
    theta_q = torch.where(unbounded, math.inf, tmin)
    return q, theta_q, unbounded


def ratio_argmin_harris(
    x_b: torch.Tensor,
    alpha: torch.Tensor,
    basis: torch.Tensor,
    pivot_tol: float,
    use_bland: torch.Tensor,
    feas_tol: float = 1e-6,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Harris two-pass ratio test; same contract as :func:`ratio_argmin`.

    Pass 1 bounds the step by theta_max = min (max(x_b, 0) + feas_tol) /
    alpha; pass 2 takes the largest alpha (lowest index on ties) among rows
    whose true ratio is within theta_max, and theta_q is that row's own
    ratio. Bland's rule keeps the classic exact-minimum tie-break.
    """
    mask = alpha > pivot_tol
    unbounded = ~mask.any()
    safe_alpha = torch.where(mask, alpha, 1)
    x_pos = x_b.clamp_min(0)
    theta_max = torch.where(mask, (x_pos + feas_tol) / safe_alpha, math.inf).min()
    theta = torch.where(mask, x_pos / safe_alpha, math.inf)
    ok = mask & (theta <= theta_max)
    q_harris = torch.argmax(torch.where(ok, alpha, -math.inf))
    tmin = theta.min()
    q_bland = torch.argmin(torch.where(theta == tmin, basis, INT_MAX))
    q = torch.where(use_bland, q_bland, q_harris).to(torch.int32)
    theta_at_q = theta.index_select(0, q.view(1)).view(())
    theta_q = torch.where(
        unbounded, math.inf, torch.where(use_bland, tmin, theta_at_q)
    )
    return q, theta_q, unbounded


def ratio_argmin_bounded(
    x_b: torch.Tensor,
    d: torch.Tensor,
    u_basic: torch.Tensor,
    u_p: torch.Tensor,
    basis: torch.Tensor,
    pivot_tol: float,
    use_bland: torch.Tensor,
    harris: bool,
    feas_tol: float,
):
    """Two-sided ratio test of the bounded-variable rule,
    ``(q, theta, unbounded, flip, leave_upper)``.

    ``d = sigma * alpha`` is the rate at which each basic value decreases
    per unit step (sigma = -1 when the entering column leaves its upper
    bound). A row blocks at its lower bound 0 (d_i > tol) or at a finite
    upper u_i (d_i < -tol); the entering column blocks itself at u_p, the
    bound flip, preferred on ties. Harris relaxes both row bounds by
    feas_tol in pass 1 and takes the largest |d| among rows within it;
    Bland's rule takes the exact minimum, smallest basis index on ties.
    ``leave_upper``: the leaving variable exits at its upper bound.
    Unbounded iff no row blocks and u_p is infinite.
    """
    dec = d > pivot_tol
    inc = (d < -pivot_tol) & torch.isfinite(u_basic)
    x_pos = x_b.clamp_min(0)
    gap_pos = (u_basic - x_b).clamp_min(0)
    safe_dec = torch.where(dec, d, 1)
    safe_inc = torch.where(inc, -d, 1)
    theta_dec = torch.where(dec, x_pos / safe_dec, math.inf)
    theta_inc = torch.where(inc, gap_pos / safe_inc, math.inf)
    theta_row = torch.minimum(theta_dec, theta_inc)
    blocks = dec | inc
    any_row = blocks.any()
    unbounded = ~any_row & ~torch.isfinite(u_p)
    tmin = theta_row.min()
    if harris:
        rel_dec = torch.where(dec, (x_pos + feas_tol) / safe_dec, math.inf)
        rel_inc = torch.where(inc, (gap_pos + feas_tol) / safe_inc, math.inf)
        theta_max = torch.minimum(rel_dec, rel_inc).min()
        ok = blocks & (theta_row <= theta_max)
        q_harris = torch.argmax(torch.where(ok, d.abs(), -math.inf))
    else:
        theta_max = tmin
        q_harris = torch.argmin(theta_row)
    q_bland = torch.argmin(torch.where(theta_row == tmin, basis, INT_MAX))
    q = torch.where(use_bland, q_bland, q_harris).to(torch.int32)
    qv = q.view(1)
    theta_q = torch.where(use_bland, tmin, theta_row.index_select(0, qv).view(()))
    row_bound = torch.where(use_bland, tmin, theta_max)
    flip = ~unbounded & (u_p <= row_bound)
    theta = torch.where(flip, u_p, torch.where(any_row, theta_q, math.inf))
    leave_upper = (theta_inc.index_select(0, qv) < theta_dec.index_select(0, qv)).view(())
    return q, theta, unbounded, flip, leave_upper


def ratio_eta(
    x_b: torch.Tensor,
    alpha: torch.Tensor,
    basis: torch.Tensor,
    pivot_tol: float,
    use_bland: torch.Tensor,
    harris: bool,
    feas_tol: float = 1e-6,
):
    """``(q, theta_q, unbounded, eta, x_b_new)``: the ratio test, then the
    product-form eta vector and the stepped x_b as if the pivot on row q
    proceeds (``simplex_tpu.kernels.pallas_ops.ratio_eta``'s epilogue):
    eta_i = -alpha_i / alpha_q, eta_q = 1/alpha_q - 1; x_b_i - theta_q
    alpha_i, with theta_q at row q. A step that cannot proceed (unbounded,
    non-finite theta_q) uses alpha_q = 1, theta_q = 0; the caller discards
    it. The plain version of the fused CUDA kernel."""
    if harris:
        q, theta_q, unbounded = ratio_argmin_harris(
            x_b, alpha, basis, pivot_tol, use_bland, feas_tol
        )
    else:
        q, theta_q, unbounded = ratio_argmin(x_b, alpha, basis, pivot_tol, use_bland)
    live = ~unbounded & torch.isfinite(theta_q)
    alpha_q = alpha.index_select(0, q.view(1)).view(())
    inv_aq = 1 / torch.where(live, alpha_q, 1)
    th = torch.where(live, theta_q, 0)
    sel = torch.arange(alpha.shape[0], device=alpha.device) == q
    eta = torch.where(sel, inv_aq - 1, -alpha * inv_aq)
    x_b_new = torch.where(sel, th, x_b - th * alpha)
    return q, theta_q, unbounded, eta, x_b_new


class PivotTail(NamedTuple):
    """What an unbounded pivot step stores after its ftran
    (:func:`pivot_tail`)."""

    x_b: torch.Tensor  # (m,)
    y: torch.Tensor  # (m,)
    c_b: torch.Tensor  # (m,)
    basis: torch.Tensor  # (m,) int32
    iters: torch.Tensor  # () int32
    status: torch.Tensor  # () int32
    degen: torch.Tensor  # () int32
    npend: Optional[torch.Tensor]  # () int32, deferred updates only
    eta: torch.Tensor  # (m,), zero when the step does not pivot
    row: torch.Tensor  # (m,) row q of the true inverse, zero likewise
    q: torch.Tensor  # () int32
    theta_q: torch.Tensor  # ()
    optimal: torch.Tensor  # () bool
    unbounded: torch.Tensor  # () bool
    bad: torch.Tensor  # () bool
    take: torch.Tensor  # () bool


def pivot_tail(
    x_b: torch.Tensor,
    alpha: torch.Tensor,
    basis: torch.Tensor,
    y: torch.Tensor,
    c_b: torch.Tensor,
    B_inv: torch.Tensor,
    min_e: torch.Tensor,
    e_p: torch.Tensor,
    c_p: torch.Tensor,
    p: torch.Tensor,
    iters: torch.Tensor,
    degen: torch.Tensor,
    *,
    eps: float,
    pivot_tol: float,
    feas_tol: float,
    harris: bool,
    degen_tol: float,
    bland_after: int,
    U: Optional[torch.Tensor] = None,
    R: Optional[torch.Tensor] = None,
    npend: int = 0,
    npend_t: Optional[torch.Tensor] = None,
) -> PivotTail:
    """The O(m) tail of an unbounded pivot step, from its ftran ``alpha`` on
    (``simplex_tpu.core.step.pivot_step`` after the ftran; the plain version
    of the CUDA tail kernel):

      optimal    min_e >= -eps
      ratio test :func:`ratio_eta` (Harris or classic; Bland's rule when
                 ``degen >= bland_after > 0``): q, theta_q, unbounded
      bad        min_e not finite, or a pivot about to be taken with a
                 non-finite theta_q;  take = ~optimal & ~unbounded & ~bad
      eta, row   the product-form eta vector and a copy of row q of the true
                 inverse (``B_inv[q]``, plus ``U[:, q] @ R`` under deferred
                 updates); both zero unless ``take``. Under deferred updates
                 they are written into row ``npend`` (the host's count of
                 pending pairs) of U and R in place, and ``npend_t + take``
                 is returned
      x_b        stepped by theta_q along alpha, theta_q at row q
      y          y - (e_p / alpha_q) row;  c_b[q] = c_p;  basis[q] = p
      iters + 1; degen + 1 when theta_q <= degen_tol, else 0; status

    A step that does not ``take`` returns x_b, y, c_b, basis, iters and degen
    as they were (new tensors) and its terminal status."""
    optimal = min_e >= -eps
    if bland_after > 0:
        use_bland = degen >= bland_after
    else:
        use_bland = torch.zeros((), dtype=torch.bool, device=degen.device)
    q, theta_q, unbounded, eta, x_b_new = ratio_eta(
        x_b, alpha, basis, pivot_tol, use_bland, harris, feas_tol
    )
    take = ~optimal & ~unbounded
    bad = ~torch.isfinite(min_e) | (take & ~torch.isfinite(theta_q))
    take = take & ~bad
    alpha_q = alpha.index_select(0, q.view(1)).view(())
    inv_aq = 1 / torch.where(take, alpha_q, 1)
    theta_safe = torch.where(take, theta_q, 0)
    is_q = torch.arange(basis.shape[0], device=q.device) == q
    # row q of the OLD inverse, as a copy: the update that follows rewrites
    # B_inv in place
    row = B_inv.index_select(0, q.view(1)).view(-1)
    if U is not None:
        # row q of the TRUE inverse: base row + pending corrections
        row = row + U.index_select(1, q.view(1)).view(-1) @ R
    eta = torch.where(take, eta, 0)
    row_out = torch.where(take, row, 0)
    npend_new = None
    if U is not None:
        # append (eta, row) at slot npend; a zero pair when not pivoting
        U[npend] = eta
        R[npend] = row_out
        eta, row_out = U[npend], R[npend]
        npend_new = npend_t + take.to(torch.int32)
    y_new = y - (e_p * inv_aq) * row
    at_q = is_q & take
    degen_new = torch.where(theta_safe <= degen_tol, degen + 1, torch.zeros_like(degen))
    status = torch.where(
        optimal,
        int(SolveStatus.OPTIMAL),
        torch.where(
            unbounded,
            int(SolveStatus.UNBOUNDED),
            torch.where(bad, int(SolveStatus.SINGULAR), int(SolveStatus.RUNNING)),
        ),
    ).to(torch.int32)
    return PivotTail(
        x_b=torch.where(take, x_b_new, x_b),
        y=torch.where(take, y_new, y),
        c_b=torch.where(at_q, c_p, c_b),
        basis=torch.where(at_q, p, basis),
        iters=iters + take.to(torch.int32),
        status=status,
        degen=torch.where(take, degen_new, degen),
        npend=npend_new,
        eta=eta,
        row=row_out,
        q=q,
        theta_q=theta_q,
        optimal=optimal,
        unbounded=unbounded,
        bad=bad,
        take=take,
    )


def rank1_update(
    B_inv: torch.Tensor, eta: torch.Tensor, binv_q: torch.Tensor
) -> torch.Tensor:
    """``B_inv += eta (x) binv_q`` IN PLACE (one BLAS ger); returns B_inv.

    In place, unlike the JAX version, so the m^2 inverse is never copied.
    ``binv_q`` must therefore not be a view of B_inv (pass a copy of row q).
    """
    return B_inv.addr_(eta, binv_q)


def rank1_update_ftran(
    B_inv: torch.Tensor, eta: torch.Tensor, binv_q: torch.Tensor, a: torch.Tensor,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`rank1_update` in place, then ``alpha = B_inv @ a`` of the
    updated inverse (into ``out`` when given): the next step's ftran, as
    the step computes it without the fused kernel."""
    rank1_update(B_inv, eta, binv_q)
    return torch.mv(B_inv, a, out=out)


# --------------------------------------------------------------------------
# batched twins: a leading batch axis B, one instance a row
# --------------------------------------------------------------------------


def rmat_batched(Y: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """Y . A over a dense A, accumulated in Y's dtype (a bf16 shadow is
    upcast): row i of Y (B, m) against A[i] of a per-instance stack (B, m,
    n), or any (k, m) rows against one (m, n) A (one matrix product)."""
    A = A.to(Y.dtype)
    if A.dim() == 2:
        return Y @ A
    return torch.bmm(Y[:, None, :], A)[:, 0]


def add_basic_penalty_batched(s: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """s[i] + BASIC_PENALTY at the columns basis[i] that fall in [0, n) (a
    window's basis, shifted by its start, reaches outside it)."""
    n = s.shape[1]
    inside = (basis >= 0) & (basis < n)
    # -0.0 adds nothing to any value, -0.0 included
    pen = torch.where(inside, BASIC_PENALTY, -0.0).to(s.dtype)
    return s.scatter_add(1, basis.long().clamp(0, n - 1), pen)


def choose_from_costs_batched(
    e: torch.Tensor,
    eps: float,
    use_bland: torch.Tensor,
    basis: torch.Tensor,
    at_upper: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(p (B,) int32, min_e (B,))`` from the reduced costs e (B, n): the
    masked (under ``at_upper``, signed) lowest-index argmin, or per instance
    where ``use_bland`` (B,) the first column with e < -eps."""
    if at_upper is not None:
        e = torch.where(at_upper, -e, e)
    e = add_basic_penalty_batched(e, basis)
    p_dantzig = torch.argmin(e, 1)
    p_bland = torch.argmax((e < -eps).to(torch.int32), 1)
    p = torch.where(use_bland.to(torch.bool), p_bland, p_dantzig)
    return p.to(torch.int32), e.min(1).values


def window_starts(window, n: int) -> torch.Tensor:
    """Each instance's first column of a pricing window ``(w, S, seg)``:
    (seg[i] mod S) * w, int64 (B,), on seg's device. The window's S
    starts must fit in a row of n columns."""
    w, S, seg = window
    if w < 1 or S < 1 or S * w > n:
        raise ValueError(f"window: {S} segments of {w} columns do not fit in {n}")
    return torch.remainder(seg.long(), S) * w


def window_slice(A: torch.Tensor, lo: torch.Tensor, w: int) -> torch.Tensor:
    """Columns [lo[i], lo[i] + w) of A for every instance, as one
    contiguous (B, m, w) stack: of A[i] for a per-instance A, of the
    shared A otherwise."""
    Bn = lo.shape[0]
    cols = lo[:, None] + torch.arange(w, device=lo.device)
    if A.dim() == 2:
        return A.index_select(1, cols.reshape(-1)).view(A.shape[0], Bn, w).permute(1, 0, 2).contiguous()
    return A.gather(2, cols[:, None, :].expand(Bn, A.shape[1], w))


def window_groups(seg: torch.Tensor, S: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The instances grouped by window: ``(perm (B,) int32, offsets (S + 1,)
    int32)`` with the instances of window s = seg mod S at
    perm[offsets[s] : offsets[s + 1]], ascending (a stable sort by window)."""
    s = torch.remainder(seg.long(), S)
    offsets = torch.zeros(S + 1, dtype=torch.int64, device=seg.device)
    offsets[1:] = torch.cumsum(torch.bincount(s, minlength=S), 0)
    return torch.argsort(s, stable=True).to(torch.int32), offsets.to(torch.int32)


def choose_entering_batched(
    y: torch.Tensor,
    A: torch.Tensor,
    c: torch.Tensor,
    eps: float,
    use_bland: torch.Tensor,
    basis: torch.Tensor,
    at_upper: Optional[torch.Tensor] = None,
    window=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`choose_entering` (``at_upper`` None) or
    :func:`choose_entering_bounded` (the signed mode) for every instance,
    over e = y[i] . A[i] - c[i] accumulated in c's dtype. A is dense: per
    instance (B, m, n) (fp32 or the bf16 shadow) or one (m, n) every
    instance shares; c is (B, n) or a shared (n,). basis (B, m) int32,
    at_upper (B, n) bool, ``use_bland`` (B,) bool.

    ``window = (w, S, seg)`` (seg an int32 (B,) tensor, such as the
    iteration counts) prices only columns [lo_i, lo_i + w) of instance i,
    lo_i = (seg[i] mod S) * w (segmented pricing): by definition the call
    on each instance's contiguous slice of A, c and at_upper, with the
    basic columns of the slice masked and lo_i added to the pick (under
    Bland's rule with no eligible column, lo_i itself)."""
    if window is not None:
        n = A.shape[-1]
        w = window[0]
        lo = window_starts(window, n)
        cols = lo[:, None] + torch.arange(w, device=lo.device)
        c_w = c.index_select(0, cols.reshape(-1)).view(cols.shape) if c.dim() == 1 else c.gather(1, cols)
        up_w = None if at_upper is None else at_upper.gather(1, cols)
        p, min_e = choose_entering_batched(
            y, window_slice(A, lo, w), c_w, eps, use_bland, (basis - lo[:, None]).to(torch.int32), up_w
        )
        return (p + lo).to(torch.int32), min_e
    e = rmat_batched(y.to(c.dtype), A) - c
    return choose_from_costs_batched(e, eps, use_bland, basis, at_upper)


def devex_choose_batched(
    e: torch.Tensor, gamma: torch.Tensor, eps: float, use_bland: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`devex_choose` for every instance: e, gamma (B, n), use_bland
    (B,) bool; ``(p (B,) int32, min_e (B,))``. The lowest-index argmax of
    e^2 / gamma over the columns with e < -eps (basic columns are not
    masked, as in the single op: the caller's exact recheck catches a
    drifted basic pick); min_e is the minimum of e."""
    neg = e < -eps
    score = torch.where(neg, (e * e) / gamma, -math.inf)
    p_bland = torch.argmax(neg.to(torch.int32), 1)
    p = torch.where(use_bland.to(torch.bool), p_bland, torch.argmax(score, 1))
    return p.to(torch.int32), e.min(1).values


def devex_choose_bounded_batched(
    e: torch.Tensor,
    gamma: torch.Tensor,
    at_upper: torch.Tensor,
    eps: float,
    use_bland: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`devex_choose_bounded` for every instance, ``(p, min_s)``:
    eligibility and the termination value take the signed reduced cost
    s = at_upper ? -e : e, the score e^2 / gamma is sign-free."""
    s = torch.where(at_upper, -e, e)
    neg = s < -eps
    score = torch.where(neg, (e * e) / gamma, -math.inf)
    p_bland = torch.argmax(neg.to(torch.int32), 1)
    p = torch.where(use_bland.to(torch.bool), p_bland, torch.argmax(score, 1))
    return p.to(torch.int32), s.min(1).values


def _ratio_batched(x_b, alpha, basis, pivot_tol, use_bland, harris, feas_tol):
    """:func:`ratio_argmin_harris` / :func:`ratio_argmin` along dim 1."""
    mask = alpha > pivot_tol
    unbounded = ~mask.any(1)
    safe_alpha = torch.where(mask, alpha, 1)
    x_pos = x_b.clamp_min(0)
    theta = torch.where(mask, x_pos / safe_alpha, math.inf)
    tmin = theta.min(1).values
    if harris:
        theta_max = torch.where(mask, (x_pos + feas_tol) / safe_alpha, math.inf).min(1).values
        ok = mask & (theta <= theta_max[:, None])
        q_fast = torch.argmax(torch.where(ok, alpha, -math.inf), 1)
    else:
        q_fast = torch.argmin(theta, 1)
    q_bland = torch.argmin(torch.where(theta == tmin[:, None], basis, INT_MAX), 1)
    q = torch.where(use_bland, q_bland, q_fast)
    theta_at_q = theta.gather(1, q[:, None])[:, 0]
    theta_q = torch.where(unbounded, math.inf, torch.where(use_bland, tmin, theta_at_q))
    return q.to(torch.int32), theta_q, unbounded


def pivot_tail_batched(
    x_b: torch.Tensor,
    alpha: torch.Tensor,
    basis: torch.Tensor,
    y: torch.Tensor,
    c_b: torch.Tensor,
    B_inv: torch.Tensor,
    min_e: torch.Tensor,
    e_p: torch.Tensor,
    c_p: torch.Tensor,
    p: torch.Tensor,
    iters: torch.Tensor,
    degen: torch.Tensor,
    status: torch.Tensor,
    active: torch.Tensor,
    *,
    eps: float,
    pivot_tol: float,
    feas_tol: float,
    harris: bool,
    degen_tol: float,
    bland_after: int,
    U: Optional[torch.Tensor] = None,
    R: Optional[torch.Tensor] = None,
    npend: Optional[torch.Tensor] = None,
) -> PivotTail:
    """:func:`pivot_tail` for every instance at once: the vectors (B, m),
    B_inv (B, m, m), the scalars (B,). An instance that is not ``active``
    (its status is terminal, or it reached the pivot limit) is left as it
    was, bit for bit: its x_b, y, c_b, basis, iters, degen and ``status``
    come back unchanged, its eta and row are zero, q and theta_q are 0 and
    every flag is False.

    Deferred updates: U, R (B, L, m) and the per-instance pending counts
    ``npend`` (B,) int32 (each below L). Row q of the true inverse adds the
    pending pairs in pair order, one multiply and one add each (the kernel's
    order; :func:`pivot_tail` sums them through a matrix product, so the two
    agree to rounding there). The pair of a pivoting instance is written
    into its slot ``npend[i]`` of U and R in place; ``npend + take`` comes
    back."""
    Bn, m = x_b.shape
    use_bland = degen >= bland_after if bland_after > 0 else torch.zeros_like(active)
    optimal = min_e >= -eps
    q, theta_q, unbounded = _ratio_batched(
        x_b, alpha, basis, pivot_tol, use_bland, harris, feas_tol
    )
    take = ~optimal & ~unbounded
    bad = ~torch.isfinite(min_e) | (take & ~torch.isfinite(theta_q))
    take = take & ~bad & active
    q2 = q.long()[:, None]
    alpha_q = alpha.gather(1, q2)[:, 0]
    live = ~unbounded & torch.isfinite(theta_q)
    inv_go = 1 / torch.where(live, alpha_q, 1)
    th = torch.where(live, theta_q, 0)
    sel = torch.arange(m, device=x_b.device)[None, :] == q2
    eta = torch.where(sel, (inv_go - 1)[:, None], -alpha * inv_go[:, None])
    x_b_new = torch.where(sel, th[:, None], x_b - th[:, None] * alpha)
    inv_aq = 1 / torch.where(take, alpha_q, 1)
    theta_safe = torch.where(take, theta_q, 0)
    row = B_inv.gather(1, q2[:, :, None].expand(Bn, 1, m))[:, 0]
    if U is not None:
        uq = U.gather(2, q2[:, None, :].expand(Bn, U.shape[1], 1))[:, :, 0]  # (B, L)
        for k in range(U.shape[1]):
            nxt = row + uq[:, k, None] * R[:, k]
            row = torch.where((k < npend)[:, None], nxt, row)
    eta = torch.where(take[:, None], eta, 0)
    row_out = torch.where(take[:, None], row, 0)
    npend_new = None
    if U is not None:
        slot = npend.long()[:, None, None].expand(Bn, 1, m)
        U.scatter_(1, slot, torch.where(take[:, None], eta, U.gather(1, slot)[:, 0])[:, None])
        R.scatter_(1, slot, torch.where(take[:, None], row_out, R.gather(1, slot)[:, 0])[:, None])
        npend_new = npend + take.to(torch.int32)
    y_new = y - (e_p * inv_aq)[:, None] * row
    at_q = sel & take[:, None]
    degen_new = torch.where(theta_safe <= degen_tol, degen + 1, torch.zeros_like(degen))
    status_new = torch.where(
        optimal,
        int(SolveStatus.OPTIMAL),
        torch.where(
            unbounded,
            int(SolveStatus.UNBOUNDED),
            torch.where(bad, int(SolveStatus.SINGULAR), int(SolveStatus.RUNNING)),
        ),
    ).to(torch.int32)
    off = ~active
    return PivotTail(
        x_b=torch.where(take[:, None], x_b_new, x_b),
        y=torch.where(take[:, None], y_new, y),
        c_b=torch.where(at_q, c_p[:, None], c_b),
        basis=torch.where(at_q, p[:, None], basis),
        iters=iters + take.to(torch.int32),
        status=torch.where(active, status_new, status),
        degen=torch.where(take, degen_new, degen),
        npend=npend_new,
        eta=eta,
        row=row_out,
        q=torch.where(off, 0, q),
        theta_q=torch.where(off, 0.0, theta_q),
        optimal=optimal & active,
        unbounded=unbounded & active,
        bad=bad & active,
        take=take,
    )


def rank1_update_batched(
    B_inv: torch.Tensor, eta: torch.Tensor, row: torch.Tensor, take: torch.Tensor
) -> torch.Tensor:
    """``B_inv[i] += eta[i] (x) row[i]`` IN PLACE for every instance with
    ``take[i]``; the others are left bit for bit. Each element is one
    multiply and one add, each rounded (no fused multiply-add), as the
    kernel computes it; :func:`rank1_update` (a BLAS ger) may fuse them, so
    a loop of it agrees to rounding. B_inv (B, m, m); eta, row (B, m);
    take (B,) bool. ``row`` must not alias B_inv."""
    upd = B_inv + eta[:, :, None] * row[:, None, :]
    return B_inv.copy_(torch.where(take[:, None, None], upd, B_inv))


def ratio_argmin_bounded_batched(
    x_b: torch.Tensor,
    d: torch.Tensor,
    u_basic: torch.Tensor,
    u_p: torch.Tensor,
    basis: torch.Tensor,
    pivot_tol: float,
    use_bland: torch.Tensor,
    harris: bool,
    feas_tol: float,
):
    """:func:`ratio_argmin_bounded` along dim 1: x_b, d, u_basic, basis
    (B, m); u_p, use_bland (B,). Returns ``(q, theta, unbounded, flip,
    leave_upper)``, each (B,)."""
    dec = d > pivot_tol
    inc = (d < -pivot_tol) & torch.isfinite(u_basic)
    x_pos = x_b.clamp_min(0)
    gap_pos = (u_basic - x_b).clamp_min(0)
    safe_dec = torch.where(dec, d, 1)
    safe_inc = torch.where(inc, -d, 1)
    theta_dec = torch.where(dec, x_pos / safe_dec, math.inf)
    theta_inc = torch.where(inc, gap_pos / safe_inc, math.inf)
    theta_row = torch.minimum(theta_dec, theta_inc)
    blocks = dec | inc
    any_row = blocks.any(1)
    unbounded = ~any_row & ~torch.isfinite(u_p)
    tmin = theta_row.min(1).values
    if harris:
        rel_dec = torch.where(dec, (x_pos + feas_tol) / safe_dec, math.inf)
        rel_inc = torch.where(inc, (gap_pos + feas_tol) / safe_inc, math.inf)
        theta_max = torch.minimum(rel_dec, rel_inc).min(1).values
        ok = blocks & (theta_row <= theta_max[:, None])
        q_fast = torch.argmax(torch.where(ok, d.abs(), -math.inf), 1)
    else:
        theta_max = tmin
        q_fast = torch.argmin(theta_row, 1)
    q_bland = torch.argmin(torch.where(theta_row == tmin[:, None], basis, INT_MAX), 1)
    q = torch.where(use_bland, q_bland, q_fast)
    q2 = q[:, None]
    theta_q = torch.where(use_bland, tmin, theta_row.gather(1, q2)[:, 0])
    row_bound = torch.where(use_bland, tmin, theta_max)
    flip = ~unbounded & (u_p <= row_bound)
    theta = torch.where(flip, u_p, torch.where(any_row, theta_q, math.inf))
    leave_upper = (theta_inc.gather(1, q2) < theta_dec.gather(1, q2))[:, 0]
    return q.to(torch.int32), theta, unbounded, flip, leave_upper
