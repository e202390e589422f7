"""The batched dual simplex: many rhs scenarios re-solved from one basis.

``simplex_tpu.core.dual._warm_jit`` vmapped over the scenarios
(``simplex_tpu.batch.vmapped.reoptimize_batched``): A, c and the bounds are
shared, each scenario has its own b and so its own x_b, B_inv and path. One
batched dual step is :func:`simplex_tpu_torch.core.dual.dual_select` and
``dual_pivot_step`` with a leading axis B:

  leaving   r = argmax violation per scenario (Bland: the violating row of
            smallest basis index); a scenario whose violations are within
            feas_tol (1 + |x_b|_inf) is primal feasible: its dual loop ends
  btran     the stacked (2B, m) x (m, n) product [y; B_inv[r]] . A: ONE
            GEMM in the working dtype (fp32 without TF32, or fp64) for a
            dense A, one SpMM over A^T for a sparse one: the reduced costs
            and the pivot rows of every scenario
  ratio     Harris over the eligible nonbasic columns, or on a bounded
            problem under ``dual_flip`` the long step (a stable argsort per
            scenario); INFEASIBLE where no column is eligible
  update    ftran as one batched product, then the primal step's algebra
            with q = r, the inverse through ``rank1_update_batched`` (the
            batched rank-1 kernel, which reads each scenario's take flag)

Everything a step decides is computed before the loop's one read a batch
step; that read also says whether any long step flipped a column (then
x_b absorbs B_inv A dx). ``refactor_every`` re-inverts the due scenarios
(one more read, on such steps only). After the dual loop the scenarios it
left OPTIMAL re-invert and run the batched primal loop
(:func:`simplex_tpu_torch.batch.step.batch_solve_state`, which prices a
dense shared A through the batched pricing kernel) to certify optimality;
the others keep their status. Under devex and steepest edge the state
carries e and gamma through the dual loop untouched (it never reads them);
at the switch the re-inversion re-derives e, devex restarts its weights at
1 and steepest edge recomputes 1 + |B_inv A_j|^2 for the scenarios that go
on, in chunks of scenarios (``step.steepest_gamma_batched``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from simplex_tpu_torch.batch import step as _bs
from simplex_tpu_torch.config import SimplexOptions
from simplex_tpu_torch.core.state import Problem, SolverState
from simplex_tpu_torch.core.step import _use_bland
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.status import SolveStatus

RUNNING = _bs.RUNNING


class BatchDualPick(NamedTuple):
    """What a batched dual step decides before it changes the state."""

    r: torch.Tensor  # (B,) int64 leaving rows
    leave_upper: torch.Tensor  # (B,) bool
    p: torch.Tensor  # (B,) int32 entering columns
    mu: torch.Tensor  # (B,)
    e_p: torch.Tensor  # (B,)
    binv_r: torch.Tensor  # (B, m) rows r of B_inv
    alpha: torch.Tensor  # (B, m)
    take: torch.Tensor  # (B,) bool
    status: torch.Tensor  # (B,) int32 after the step
    dx: Optional[torch.Tensor]  # (B, n) long-step flips' change of x_N
    flip_mask: Optional[torch.Tensor]  # (B, n) bool


def dual_select(prob: Problem, s: SolverState, opts: SimplexOptions, active) -> BatchDualPick:
    """The selection half of the batched dual step (changes nothing)."""
    dtype = s.B_inv.dtype
    Bn, m = s.x_b.shape
    n = prob.A.shape[1]
    dev = s.x_b.device
    eps_d = opts.resolve_eps()
    bounded = prob.u is not None
    use_bland = _use_bland(opts, s.degen)

    low = -s.x_b
    if bounded:
        u_basic = prob.u.index_select(0, s.basis.reshape(-1).long()).view(Bn, m).to(dtype)
        up = s.x_b - u_basic
        v = torch.maximum(low, up)
        over_upper = up > low
    else:
        v = low
        over_upper = torch.zeros_like(v, dtype=torch.bool)
    maxv = v.max(1).values
    feas_bound = opts.feas_tol * (1 + s.x_b.abs().max(1).values)
    feasible = maxv <= feas_bound
    viol = v > feas_bound[:, None]
    r_dantzig = torch.argmax(v, 1)
    r_bland = torch.argmin(torch.where(viol, s.basis, _ops.INT_MAX), 1)
    r = torch.where(use_bland, r_bland, r_dantzig)
    r2 = r[:, None]
    leave_upper = over_upper.gather(1, r2)[:, 0]

    binv_r = s.B_inv.gather(1, r2[:, :, None].expand(Bn, 1, m))[:, 0]
    ew = _bs.rmat(prob.A, torch.cat([s.y, binv_r]))
    e = ew[:Bn] - prob.c.to(dtype)
    w = ew[Bn:]

    is_basic = torch.zeros((Bn, n), dtype=torch.bool, device=dev).scatter_(1, s.basis.long(), True)
    g = torch.where(leave_upper[:, None], w, -w)
    if bounded:
        at_up = s.at_upper
        elig = ~is_basic & torch.where(at_up, g < -opts.pivot_tol, g > opts.pivot_tol)
        elig = elig & (prob.u > 0)
        d_pos = torch.where(at_up, -e, e).clamp_min(0)
    else:
        elig = ~is_basic & (g > opts.pivot_tol)
        d_pos = e.clamp_min(0)
    absg = g.abs()
    safe_g = torch.where(elig, absg, 1)
    mu_all = torch.where(elig, d_pos / safe_g, math.inf)
    mu_min = mu_all.min(1).values
    p_bland = torch.argmax(((mu_all == mu_min[:, None]) & elig).to(torch.int32), 1)

    long_step = bounded and opts.dual_flip
    flip_raw = u_safe = None
    if long_step:
        slope0 = v.gather(1, r2)[:, 0]
        u_all = prob.u.to(dtype)
        finite_u = torch.isfinite(u_all)
        u_safe = torch.where(finite_u, u_all, 1)
        weight = torch.where(elig, torch.where(finite_u, u_safe * absg, math.inf), 0)
        # stable: the ineligible columns tie at +inf behind every eligible one
        order = torch.argsort(mu_all, dim=1, stable=True)
        crossed = weight.gather(1, order).cumsum(1) >= slope0[:, None]
        found = crossed.any(1)
        sel_k = torch.argmax(crossed.to(torch.int32), 1)
        p_flip = order.gather(1, sel_k[:, None])[:, 0]
        flip_sorted = torch.arange(n, device=dev)[None, :] < sel_k[:, None]
        flip_raw = torch.zeros((Bn, n), dtype=torch.bool, device=dev).scatter_(1, order, flip_sorted)
        flip_raw = flip_raw & elig & finite_u
        infeasible = ~feasible & torch.where(use_bland, ~elig.any(1), ~found)
        p = torch.where(use_bland, p_bland, p_flip)
        mu = mu_all.gather(1, p[:, None])[:, 0]
    else:
        infeasible = ~feasible & ~elig.any(1)
        mu_max = torch.where(elig, (d_pos + eps_d) / safe_g, math.inf).min(1).values
        ok = elig & (mu_all <= mu_max[:, None])
        p_harris = torch.argmax(torch.where(ok, absg, -math.inf), 1)
        p = torch.where(use_bland, p_bland, p_harris)
        mu = torch.where(use_bland, mu_min, mu_all.gather(1, p[:, None])[:, 0])
    p = p.to(torch.int32)

    A_p = _bs.entering_columns(prob.A, p).to(dtype)
    alpha = torch.bmm(s.B_inv, A_p[:, :, None])[:, :, 0]
    alpha_r = alpha.gather(1, r2)[:, 0]
    take = ~feasible & ~infeasible & active
    bad = take & (alpha_r.abs() <= opts.pivot_tol)
    take = take & ~bad
    status = torch.where(
        feasible,
        int(SolveStatus.OPTIMAL),
        torch.where(
            infeasible,
            int(SolveStatus.INFEASIBLE),
            torch.where(bad, int(SolveStatus.SINGULAR), RUNNING),
        ),
    ).to(torch.int32)
    status = torch.where(active, status, s.status)

    dx = flip_mask = None
    if long_step:
        flip_mask = flip_raw & take[:, None] & ~use_bland[:, None]
        dx = torch.where(flip_mask, torch.where(s.at_upper, -u_safe, u_safe), 0).to(dtype)
    return BatchDualPick(
        r=r, leave_upper=leave_upper, p=p, mu=mu, e_p=e.gather(1, p.long()[:, None])[:, 0],
        binv_r=binv_r, alpha=alpha, take=take, status=status, dx=dx, flip_mask=flip_mask,
    )


def dual_pivot_step(
    prob: Problem, s: SolverState, opts: SimplexOptions, pick: BatchDualPick,
    any_flip: bool, backend,
) -> SolverState:
    """Apply the picks: a pivot where ``take``, the new status everywhere
    active. Updates B_inv in place."""
    _bs.steps["dual"] += 1
    dtype = s.B_inv.dtype
    Bn, m = s.x_b.shape
    bounded = prob.u is not None
    take = pick.take
    r2 = pick.r[:, None]
    p2 = pick.p.long()[:, None]
    alpha = pick.alpha
    inv_ar = 1 / torch.where(take, alpha.gather(1, r2)[:, 0], 1)

    x_b_base = s.x_b
    if any_flip:
        x_b_base = s.x_b - torch.bmm(s.B_inv, _bs.matvec(prob.A, pick.dx)[:, :, None])[:, :, 0]
    if bounded:
        lv = s.basis.gather(1, r2)
        u_r = prob.u.index_select(0, lv.reshape(-1).long()).to(dtype)
        bound_r = torch.where(pick.leave_upper, u_r, 0)
        v_p = torch.where(
            s.at_upper.gather(1, p2)[:, 0], prob.u.index_select(0, pick.p.long()).to(dtype), 0
        )
    else:
        bound_r = v_p = torch.zeros(Bn, dtype=dtype, device=alpha.device)
    t = (x_b_base.gather(1, r2)[:, 0] - bound_r) * inv_ar
    is_r = torch.arange(m, device=alpha.device)[None, :] == r2
    x_b_new = torch.where(is_r, (v_p + t)[:, None], x_b_base - t[:, None] * alpha)

    eta = torch.where(is_r, (inv_ar - 1)[:, None], -alpha * inv_ar[:, None])
    tk = take[:, None]
    B_inv = backend.rank1_update_batched(
        s.B_inv, torch.where(tk, eta, 0), torch.where(tk, pick.binv_r, 0), take
    )
    y_new = s.y - (pick.e_p * inv_ar)[:, None] * pick.binv_r
    c_p = _bs._costs(prob.c, pick.p).to(dtype)
    at_upper = s.at_upper
    if bounded:
        au = s.at_upper if pick.flip_mask is None else s.at_upper ^ pick.flip_mask
        cols = torch.arange(s.at_upper.shape[1], device=alpha.device)[None, :]
        au = torch.where(cols == p2, False, au)
        au = torch.where(cols == lv, pick.leave_upper[:, None], au)
        at_upper = torch.where(tk, au, s.at_upper)
    degen = torch.where(pick.mu <= opts.degen_tol, s.degen + 1, torch.zeros_like(s.degen))
    at_r = is_r & tk
    return dataclasses.replace(
        s,
        B_inv=B_inv,
        x_b=torch.where(tk, x_b_new, s.x_b),
        y=torch.where(tk, y_new, s.y),
        c_b=torch.where(at_r, c_p[:, None], s.c_b),
        basis=torch.where(at_r, pick.p[:, None], s.basis),
        iters=s.iters + take.to(torch.int32),
        status=pick.status,
        degen=torch.where(take, degen, s.degen),
        at_upper=at_upper,
    )


def _control(prob, s, opts, max_iter, due=None):
    """The dual loop's one read a batch step: the next picks, whether any
    scenario is active, whether a long step flips a column, and whether a
    re-inversion is due first."""
    active = _bs.active_mask(s, max_iter)
    pick = dual_select(prob, s, opts, active)
    none = torch.zeros((), dtype=torch.int32, device=active.device)
    fields = [
        active.any(),
        none if pick.flip_mask is None else pick.flip_mask.any(),
        none if due is None else due.any(),
    ]
    vals = _bs._read(fields)
    return bool(vals[0]), bool(vals[1]), bool(vals[2]), pick


def dual_solve_state(
    prob: Problem, s: SolverState, opts: SimplexOptions, max_iter: int, backend
) -> SolverState:
    """The batched dual loop until no scenario is active, the verify rounds
    per scenario, a still-running status mapped to MAX_ITER
    (``simplex_tpu.core.dual.dual_solve_state`` under vmap)."""

    def loop(s):
        due = None
        while True:
            any_active, any_flip, any_due, pick = _control(prob, s, opts, max_iter, due)
            if any_due:
                # re-invert first; the picks are made again from it
                s = _bs.refactorize(prob, s, due)
                any_active, any_flip, _, pick = _control(prob, s, opts, max_iter)
            if not any_active:
                return s
            was = _bs.active_mask(s, max_iter)
            s = dual_pivot_step(prob, s, opts, pick, any_flip, backend)
            due = None
            if opts.refactor_every > 0:
                due = was & pick.take & (s.status == RUNNING) & (s.iters % opts.refactor_every == 0)

    s = loop(s)
    if opts.verify_terminal:
        rounds = torch.zeros_like(s.status)
        while True:
            need = (
                (s.status != RUNNING) & (s.iters < max_iter) & (s.iters > s.last_refac)
                & (rounds < _bs.MAX_VERIFY_ROUNDS)
            )
            if not _bs._read([need.any()], "maintenance")[0]:
                break
            s = _bs.refactorize(prob, s, need)
            s.status = torch.where(need, RUNNING, s.status).to(torch.int32)
            rounds = rounds + need.to(torch.int32)
            s = loop(s)
    s.status = torch.where(s.status == RUNNING, int(SolveStatus.MAX_ITER), s.status).to(torch.int32)
    return s


def warm_solve_state(
    prob: Problem, s: SolverState, opts: SimplexOptions, max_iter: int, backend
) -> SolverState:
    """The batched dual loop, then for the scenarios it left OPTIMAL an
    exact re-inversion and the batched primal loop
    (``simplex_tpu.core.dual._warm_jit``'s ``to_primal``)."""
    s = dual_solve_state(prob, s, opts, max_iter, backend)
    ok = s.status == int(SolveStatus.OPTIMAL)
    if not _bs._read([ok.any()], "maintenance")[0]:
        return s
    s = _bs.refactorize(prob, s, ok, opts.pricing, exact_gamma=opts.pricing == "steepest")
    s.status = torch.where(ok, RUNNING, s.status).to(torch.int32)
    return _bs.batch_solve_state(prob, s, opts, max_iter, backend, members=ok)
