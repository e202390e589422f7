"""Dual simplex: re-optimize from a dual-feasible basis after a rhs change.

The counterpart of ``simplex_tpu.core.dual``. After an optimal solve, a
changed ``b`` leaves the old basis dual-feasible (reduced-cost signs depend
on A and c alone) but possibly primal-infeasible; the dual simplex drives
the violations out in a few pivots instead of a cold solve. It pairs with
:mod:`simplex_tpu_torch.analysis`: inside the allowable range of b the basis
is re-priced in 0 pivots; outside it :func:`solve_dual` walks to the new
optimal basis.

One dual pivot:

  leaving   r = argmax violation v_i = max(-x_b_i, x_b_i - u_i) (under
            Bland's rule the violating row of smallest basis index); primal
            feasible, the loop's exit, iff max v <= feas_tol (1 + |x_b|_inf)
  btran     w = B_inv[r] . A and the exact reduced costs e = y.A - c as ONE
            (2, m) x (m, n) product in full fp32: the traffic of one primal
            pricing pass
  ratio     sigma = +1 leaving at upper, -1 at lower; g = sigma w; eligible
            nonbasic j: at lower with g_j > tol, at upper with g_j < -tol,
            never a fixed column (u_j = 0); mu_j = d_j / |g_j| with d_j the
            signed reduced cost clamped at 0; entering p = argmin mu,
            Harris-stabilized (largest |g| within a band of eps), or, on a
            bounded problem under ``dual_flip``, by the bound-flipping long
            step: walk the breakpoints in ascending mu (a STABLE sort: the
            ineligible columns all carry +inf), flipping every finite-bound
            column passed, until the slope |delta_r| is used up. INFEASIBLE
            iff no column is eligible (the slope survives every breakpoint):
            a Farkas proof from row r
  update    the primal step's product-form algebra with q = r and
            theta = delta_r / alpha_r: ftran, ``backend.rank1_update`` (the
            rank-1 kernel on the hopper backend), y, c_b, basis, at_upper

The dual loop reads the eager ``B_inv`` only: the deferred-update and
multiple-pricing buffers stay empty until the primal hand-over, and neither
e nor gamma is maintained (the hand-over re-derives them).

The JAX loop is one ``lax.while_loop``; here the loop runs on the host and
reads the device once a pivot (:func:`dual_control`). Everything a step
decides before it changes the state -- the leaving row, the entering column,
whether it pivots, its terminal status, and whether the long step flips any
column (the JAX step's ``lax.cond`` around an O(mn) + O(m^2) pass) -- is
computed by :func:`dual_select` ahead of that read and rides on it, so the
step itself (:func:`dual_pivot_step`) reads nothing. ``step.host_reads``
counts these reads under ``"control"``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch import spans
from simplex_tpu_torch.config import (
    DEFAULT_OPTIONS,
    SimplexOptions,
    check_supported,
    pin_full_fp32,
)
from simplex_tpu_torch.core import step as _step
from simplex_tpu_torch.core.solver import (
    MAX_VERIFY_ROUNDS,
    basis_columns64,
    finalize_result,
    solve_state,
)
from simplex_tpu_torch.core.state import (
    Problem,
    SolverState,
    initial_state,
    problem_from_numpy,
    steepest_gamma,
    with_pricing_shadow,
)
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.status import SolveStatus


class DualPick(NamedTuple):
    """What a dual step decides before it changes the state, as device
    tensors (:func:`dual_select`)."""

    r: torch.Tensor  # () int32 leaving row
    leave_upper: torch.Tensor  # () bool: the leaving variable exits at u (sigma > 0)
    p: torch.Tensor  # () int32 entering column
    mu: torch.Tensor  # () the dual step length
    e_p: torch.Tensor  # () exact reduced cost of p
    binv_r: torch.Tensor  # (m,) row r of B_inv, a copy
    alpha: torch.Tensor  # (m,) B_inv A_p
    take: torch.Tensor  # () bool: the step pivots
    status: torch.Tensor  # () int32: the state's status after the step
    flip_mask: Optional[torch.Tensor]  # (n,) bool long-step flips, or None
    dx: Optional[torch.Tensor]  # (n,) the flips' change of x_N
    any_flip: Optional[torch.Tensor]  # () bool


class DualControl(NamedTuple):
    """Host copies of the scalars the dual loop branches on, from one read,
    with the next step's pick."""

    status: int
    iters: int
    degen: int
    last_refac: int
    take: bool
    next_status: int
    any_flip: bool
    pick: DualPick


def dual_select(prob: Problem, state: SolverState, opts: SimplexOptions, backend) -> DualPick:
    """The selection half of ``simplex_tpu.core.dual.dual_pivot_step``:
    leaving row, btran row and reduced costs, the dual ratio test (Harris,
    Bland, or the bound-flipping long step), the ftran and the step's
    decisions. Changes nothing."""
    dtype = state.B_inv.dtype
    dev = state.B_inv.device
    m, n = prob.A.shape
    eps_d = opts.resolve_eps()
    bounded = prob.u is not None
    use_bland = _step._use_bland(opts, state.degen)

    # ---- leaving row: the most violating basic variable ----
    low = -state.x_b
    if bounded:
        u_basic = prob.u.index_select(0, state.basis).to(dtype)
        up = state.x_b - u_basic  # -inf where u = +inf: never wins
        v = torch.maximum(low, up)
        over_upper = up > low
    else:
        v = low
        over_upper = torch.zeros(m, dtype=torch.bool, device=dev)
    maxv = v.max()
    # relative exit test: Harris tolerates O(feas_tol) absolute
    # infeasibility, and x_b's scale is the solve's own
    feas_bound = opts.feas_tol * (1 + state.x_b.abs().max())
    feasible = maxv <= feas_bound
    viol = v > feas_bound
    r_dantzig = torch.argmax(v)
    # Bland: the smallest basis index among the violating rows
    r_bland = torch.argmin(torch.where(viol, state.basis, _ops.INT_MAX))
    r = torch.where(use_bland, r_bland, r_dantzig)
    rv = r.view(1)
    leave_upper = over_upper.index_select(0, rv).view(())

    # ---- btran row + exact reduced costs: one (2, m) x (m, n) product ----
    binv_r = state.B_inv.index_select(0, rv).view(-1)
    e, w = backend.pricing_update2(prob.A, state.y, binv_r)
    e = e - prob.c.to(dtype)

    # ---- dual ratio test over the nonbasic columns ----
    is_basic = torch.zeros(n, dtype=torch.bool, device=dev).index_fill_(
        0, state.basis.long(), True
    )
    g = torch.where(leave_upper, w, -w)
    if bounded:
        at_up = state.at_upper
        elig = ~is_basic & torch.where(at_up, g < -opts.pivot_tol, g > opts.pivot_tol)
        # fixed columns (u_j = 0, such as the artificials a warm general
        # re-solve pins out) put no constraint on the duals: never eligible
        elig = elig & (prob.u > 0)
        d_pos = torch.where(at_up, -e, e).clamp_min(0)  # clamp dual drift
    else:
        elig = ~is_basic & (g > opts.pivot_tol)
        d_pos = e.clamp_min(0)
    absg = g.abs()
    safe_g = torch.where(elig, absg, 1)
    mu_all = torch.where(elig, d_pos / safe_g, math.inf)
    mu_min = mu_all.min()
    # Bland: the first eligible column at the exact minimum ratio
    p_bland = torch.argmax(((mu_all == mu_min) & elig).to(torch.int32))

    long_step = bounded and opts.dual_flip
    flip_raw = u_safe = None
    if long_step:
        slope0 = v.index_select(0, rv).view(())
        u_all = prob.u.to(dtype)
        finite_u = torch.isfinite(u_all)
        u_safe = torch.where(finite_u, u_all, 1)  # an infinite u meets no product
        weight = torch.where(elig, torch.where(finite_u, u_safe * absg, math.inf), 0)
        # stable: the ineligible columns tie at +inf and must stay behind
        # every eligible one, in index order
        order = torch.argsort(mu_all, stable=True)
        crossed = weight.index_select(0, order).cumsum(0) >= slope0
        found = crossed.any()
        sel_k = torch.argmax(crossed.to(torch.int32))  # the first crossing
        p_flip = order.index_select(0, sel_k.view(1)).view(())
        flip_sorted = torch.arange(n, device=dev) < sel_k
        flip_raw = torch.zeros(n, dtype=torch.bool, device=dev).scatter_(0, order, flip_sorted)
        flip_raw = flip_raw & elig & finite_u
        infeasible = ~feasible & torch.where(use_bland, ~elig.any(), ~found)
        p = torch.where(use_bland, p_bland, p_flip)
        mu = mu_all.index_select(0, p.view(1)).view(())
    else:
        infeasible = ~feasible & ~elig.any()
        # Harris: pass 1 relaxes dual feasibility by eps, pass 2 takes the
        # largest |g| within the relaxed bound
        mu_max = torch.where(elig, (d_pos + eps_d) / safe_g, math.inf).min()
        ok = elig & (mu_all <= mu_max)
        p_harris = torch.argmax(torch.where(ok, absg, -math.inf))
        p = torch.where(use_bland, p_bland, p_harris)
        mu = torch.where(use_bland, mu_min, mu_all.index_select(0, p.view(1)).view(()))
    p = p.to(torch.int32)

    # ---- ftran and the step's decisions ----
    alpha = torch.mv(state.B_inv, backend.gather_column(prob.A, p).to(dtype))
    alpha_r = alpha.index_select(0, rv).view(())
    take = ~feasible & ~infeasible
    # a vanishing alpha_r would explode 1 / alpha_r
    bad = take & (alpha_r.abs() <= opts.pivot_tol)
    take = take & ~bad
    status = torch.where(
        feasible,
        int(SolveStatus.OPTIMAL),  # primal feasible: the dual loop is done
        torch.where(
            infeasible,
            int(SolveStatus.INFEASIBLE),
            torch.where(bad, int(SolveStatus.SINGULAR), int(SolveStatus.RUNNING)),
        ),
    ).to(torch.int32)

    flip_mask = dx = any_flip = None
    if long_step:
        flip_mask = flip_raw & take & ~use_bland
        dx = torch.where(flip_mask, torch.where(state.at_upper, -u_safe, u_safe), 0).to(dtype)
        any_flip = flip_mask.any()
    return DualPick(
        r=r.to(torch.int32), leave_upper=leave_upper, p=p, mu=mu,
        e_p=e.index_select(0, p.view(1)).view(()), binv_r=binv_r, alpha=alpha,
        take=take, status=status, flip_mask=flip_mask, dx=dx, any_flip=any_flip,
    )


def dual_control(prob: Problem, state: SolverState, opts: SimplexOptions, backend) -> DualControl:
    """The state's control scalars and the next step's pick and decisions in
    ONE device-to-host read."""
    pick = dual_select(prob, state, opts, backend)
    fields = [state.status, state.iters, state.degen, state.last_refac, pick.take, pick.status]
    if pick.any_flip is not None:
        fields.append(pick.any_flip)
    packed = torch.stack([f.to(torch.int32) for f in fields])
    span = spans.start("read", "control")
    vals = packed.tolist()
    spans.stop(span)
    _step.host_reads["control"] += 1
    return DualControl(
        status=vals[0], iters=vals[1], degen=vals[2], last_refac=vals[3],
        take=bool(vals[4]), next_status=vals[5],
        any_flip=bool(vals[6]) if pick.any_flip is not None else False, pick=pick,
    )


def dual_pivot_step(
    prob: Problem,
    state: SolverState,
    opts: SimplexOptions,
    backend,
    ctl: Optional[DualControl] = None,
) -> SolverState:
    """One dual pivot, or a terminal status
    (``simplex_tpu.core.dual.dual_pivot_step``). ``ctl`` is this state's
    :func:`dual_control` (read here when not given). Updates ``state.B_inv``
    in place and returns the new state; a step that does not pivot changes
    the status alone."""
    if ctl is None:
        ctl = dual_control(prob, state, opts, backend)
    pick = ctl.pick
    if not ctl.take:
        return dataclasses.replace(state, status=pick.status)
    dtype = state.B_inv.dtype
    bounded = prob.u is not None
    rv, pv = pick.r.view(1), pick.p.view(1)
    alpha = pick.alpha
    inv_ar = 1 / alpha.index_select(0, rv).view(())

    # the long step's flips: x_b absorbs A dx_N, one O(mn) + O(m^2) pass,
    # skipped when the walk passed no finite-bound column
    x_b_base = state.x_b
    if ctl.any_flip:
        x_b_base = state.x_b - torch.mv(state.B_inv, _ops.matvec(prob.A, pick.dx))

    if bounded:
        u_r = prob.u.index_select(0, state.basis.index_select(0, rv)).to(dtype).view(())
        bound_r = torch.where(pick.leave_upper, u_r, 0)
        # the entering column's current bound value (p is the crossing
        # breakpoint, never among the flips)
        v_p = torch.where(
            state.at_upper.index_select(0, pv).view(()),
            prob.u.index_select(0, pv).to(dtype).view(()), 0,
        )
    else:
        bound_r = v_p = torch.zeros((), dtype=dtype, device=alpha.device)
    t = (x_b_base.index_select(0, rv).view(()) - bound_r) * inv_ar
    is_r = torch.arange(alpha.shape[0], device=alpha.device) == pick.r
    x_b_new = torch.where(is_r, v_p + t, x_b_base - t * alpha)

    # ---- product-form update, the primal step's algebra with q = r ----
    eta = torch.where(is_r, inv_ar - 1, -alpha * inv_ar)
    B_inv = backend.rank1_update(state.B_inv, eta, pick.binv_r)
    y_new = state.y - (pick.e_p * inv_ar) * pick.binv_r
    c_p = backend.gather_cost(prob.c, pick.p).to(dtype)
    at_upper = None
    if bounded:
        lv = state.basis.index_select(0, rv).long()
        au = state.at_upper if pick.flip_mask is None else state.at_upper ^ pick.flip_mask
        at_upper = au.index_fill(0, pv.long(), False).index_copy(
            0, lv, pick.leave_upper.view(1)
        )
    degen = torch.where(pick.mu <= opts.degen_tol, state.degen + 1, torch.zeros_like(state.degen))
    return dataclasses.replace(
        state,
        B_inv=B_inv,
        x_b=x_b_new,
        y=y_new,
        c_b=torch.where(is_r, c_p, state.c_b),
        basis=torch.where(is_r, pick.p, state.basis),
        iters=state.iters + 1,
        status=pick.status,
        degen=degen,
        at_upper=at_upper,
    )


def _dual_loop(prob, s, ctl, opts, max_iter, backend):
    defer = opts.resolve_defer() > 0
    while ctl.status == SolveStatus.RUNNING and ctl.iters < max_iter:
        s = dual_pivot_step(prob, s, opts, backend, ctl)
        if not ctl.take:
            # terminal: its status came with the same read
            return s, ctl._replace(status=ctl.next_status)
        iters = ctl.iters + 1
        if opts.refactor_every > 0 and iters % opts.refactor_every == 0:
            s = _step.refactorize(prob, s, backend, defer, opts.pricing)
        ctl = dual_control(prob, s, opts, backend)
    return s, ctl


def dual_solve_state(
    prob: Problem,
    state0: SolverState,
    opts: SimplexOptions,
    max_iter: int,
    backend=None,
) -> SolverState:
    """Run the dual pivot loop until primal feasibility (status OPTIMAL),
    INFEASIBLE, SINGULAR or the pivot limit (MAX_ITER). A terminal decision
    made from a drifted product-form inverse is re-checked from an exact one,
    as in the primal :func:`~simplex_tpu_torch.core.solver.solve_state`."""
    if backend is None:
        backend = get_backend(opts.backend)
    defer = opts.resolve_defer() > 0
    s, ctl = _dual_loop(
        prob, state0, dual_control(prob, state0, opts, backend), opts, max_iter, backend
    )
    if opts.verify_terminal:
        rounds = 0
        while (
            rounds < MAX_VERIFY_ROUNDS
            and ctl.status != SolveStatus.RUNNING
            and ctl.iters < max_iter
            and ctl.iters > ctl.last_refac
        ):
            s = _step.refactorize(prob, s, backend, defer, opts.pricing)
            s.status = torch.full_like(s.status, int(SolveStatus.RUNNING))
            s, ctl = _dual_loop(
                prob, s, dual_control(prob, s, opts, backend), opts, max_iter, backend
            )
            rounds += 1
    if ctl.status == SolveStatus.RUNNING:
        s.status = torch.full_like(s.status, int(SolveStatus.MAX_ITER))
    return s


def warm_solve_state(
    prob: Problem, state0: SolverState, opts: SimplexOptions, max_iter: int, backend=None
) -> SolverState:
    """The dual loop to primal feasibility, then the primal loop to
    optimality (``simplex_tpu.core.dual._warm_jit``): at the switch the
    inverse is re-derived exactly, with it e (devex, steepest) and, for
    steepest edge, the exact weights from one B_inv . A product (the dual
    loop maintains neither)."""
    if backend is None:
        backend = get_backend(opts.backend)
    s = dual_solve_state(prob, state0, opts, max_iter, backend)
    if int(s.status) != SolveStatus.OPTIMAL:
        return s
    s = _step.refactorize(prob, s, backend, opts.resolve_defer() > 0, opts.pricing)
    if opts.pricing == "steepest":
        s.gamma = steepest_gamma(prob, s.B_inv, s.B_inv.dtype)
    s.status = torch.full_like(s.status, int(SolveStatus.RUNNING))
    return solve_state(prob, s, opts, max_iter, backend)


def _entry_dual_feasibility(A, c, basis, at_upper0, u, device) -> float:
    """The least signed reduced cost over the nonbasic, non-fixed columns of
    the entry basis, in float64 on ``device`` at every m (one LU solve);
    >= -tol means dual-feasible. -inf for a singular basis. A sparse A
    (scipy or SparseA) is checked through a float64 copy of it on
    ``device``."""
    if _sp.is_sparse(A):
        A64 = _sp.as_sparse(A.host if isinstance(A, _sp.SparseA) else A, torch.float64, device)
    else:
        A64 = torch.as_tensor(A, device=device).double()
    c64 = (c.to(device, torch.float64) if isinstance(c, torch.Tensor)
           else torch.as_tensor(np.asarray(c, np.float64), device=device))
    idx = torch.as_tensor(np.asarray(basis, np.int64), device=device)
    try:
        y = torch.linalg.solve(basis_columns64(A64, idx).T, c64.index_select(0, idx))
    except torch.linalg.LinAlgError:
        return -math.inf
    e = _ops.reduced_costs(y, A64, c64)
    if at_upper0 is not None:
        e = torch.where(torch.as_tensor(np.asarray(at_upper0, bool), device=device), -e, e)
    skip = torch.zeros_like(e, dtype=torch.bool).index_fill_(0, idx, True)
    if u is not None:
        # fixed columns are never dual-eligible in the dual step either
        skip |= torch.as_tensor(np.asarray(u, np.float64) <= 0, device=device)
    e = torch.where(skip, math.inf, e)
    min_e = float(e.min())
    return 0.0 if math.isinf(min_e) and min_e > 0 else min_e


def solve_dual(
    A,
    b,
    c,
    *,
    basis0: Optional[np.ndarray] = None,
    u=None,
    at_upper0: Optional[np.ndarray] = None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    check_entry: bool = True,
    device="cuda",
):
    """Re-solve  max c.x  s.t.  A x = b, 0 <= x (<= u)  from a DUAL-feasible
    basis (typically the optimal basis of a prior solve whose ``b``
    changed), on ``device`` (default ``"cuda"``; there is no fallback to the
    CPU).

    ``basis0=None`` takes the trailing slack basis, dual-feasible iff no
    structural cost is positive. ``at_upper0`` carries the prior solve's
    nonbasic-at-upper flags (``SolveResult.at_upper``). Returns a
    :class:`~simplex_tpu_torch.core.solver.SolveResult` as ``solve`` does:
    the dual loop restores primal feasibility, the primal loop certifies
    optimality; ``iters`` counts both. INFEASIBLE means the dual became
    unbounded: a Farkas proof that the new primal is empty.

    ``A`` may be sparse (scipy.sparse or a
    :class:`~simplex_tpu_torch.sparse.SparseA`), as in ``solve``.

    Raises ``ValueError`` when ``check_entry`` finds the entry basis not
    dual-feasible (``c`` changed, not ``b``): warm-start a cost change with
    the primal loop, ``solve(A, b, c_new, basis0=prev.basis)``.
    """
    options = check_supported(options)
    if not isinstance(A, torch.Tensor) and not _sp.is_sparse(A):
        A = np.asarray(A)
    b, c = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in (b, c))
    m, n = A.shape
    if m > n:
        raise ValueError(f"m > n ({m} > {n}): not a canonical-form LP")
    basis = np.arange(n - m, n, dtype=np.int32) if basis0 is None else np.asarray(basis0, np.int32)
    u_np = None
    if u is not None:
        u_np = np.asarray(u.cpu() if isinstance(u, torch.Tensor) else u, np.float64)
        if np.any(u_np < 0):
            raise ValueError("negative upper bound (shift lowers to 0 first)")
        if not np.any(np.isfinite(u_np)):
            u_np = None
    if u_np is None:
        at_upper0 = None
    device = torch.device(device)
    if check_entry:
        tol = 10 * options.resolve_eps()
        min_e = _entry_dual_feasibility(A, c, basis, at_upper0, u_np, device)
        if min_e < -tol:
            raise ValueError(
                f"entry basis is not dual-feasible (min signed reduced cost "
                f"{min_e:.3g} < {-tol:.3g}); the dual simplex requires one. "
                "For a cost change, warm-start the primal loop instead: "
                "solve(A, b, c, basis0=prev.basis)"
            )
    pin_full_fp32()
    dtype = options.dtype
    # sparse A: no column segments on the warm path (the full pass prices),
    # as in the JAX package
    prob = problem_from_numpy(A, b, c, device, dtype, u=u_np)
    prob = with_pricing_shadow(prob, options.pricing_dtype, options.pricing)
    # no rhs perturbation on the warm path, as in the JAX package
    state0 = initial_state(
        prob, basis, dtype, update_defer=options.resolve_defer(),
        multi_price=options.multi_price, at_upper0=at_upper0, pricing=options.pricing,
    )
    final = warm_solve_state(prob, state0, options, options.resolve_max_iter(m, n))
    return finalize_result(prob, b, c, final, options, u_np)
