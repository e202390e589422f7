"""One revised-simplex pivot on device tensors.

The dense Dantzig path of ``simplex_tpu.core.step.pivot_step`` with the
eager product-form update:

  pricing      e = y.A - c_eff (basic columns masked); p = argmin e;
               optimal iff min e >= -eps
  ftran        alpha = B_inv @ A_p
  ratio test   Harris (default) or classic; q, theta_q; unbounded iff no
               alpha_i > pivot_tol; eta and the stepped x_b from the same
               launch on the hopper backend
  update       B_inv += eta (x) B_inv[q]   (in place)
               y -= (e_p / alpha_q) B_inv_old[q];  c_b[q] = c_p;  basis[q] = p

Every decision is a device tensor: a step that does not pivot (a terminal
status) leaves the state as it was through ``torch.where`` selects and a
zeroed update, so the step never reads a value back to the host. The
solver reads the control scalars once per pivot.

Matrix products run in full fp32 (the solver turns TF32 off), the
counterpart of the JAX package's ``Precision.HIGHEST`` pins.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from simplex_tpu_torch.config import SimplexOptions
from simplex_tpu_torch.core.linalg import inverse_newton
from simplex_tpu_torch.core.state import Problem, SolverState
from simplex_tpu_torch.status import SolveStatus


def pivot_step(
    prob: Problem, state: SolverState, opts: SimplexOptions, backend
) -> SolverState:
    """Apply one pivot, or set a terminal status. Updates ``state.B_inv`` in
    place and returns the new state."""
    dtype = state.B_inv.dtype
    eps = opts.resolve_eps()
    if opts.bland_after > 0:
        use_bland = state.degen >= opts.bland_after
    else:
        use_bland = torch.zeros((), dtype=torch.bool, device=state.degen.device)

    # ---- pricing over basic-masked costs ----
    c_eff = backend.mask_basic(prob.c, state.basis)
    p, min_e = backend.choose_entering(state.y, prob.A, c_eff, eps, use_bland)
    optimal = min_e >= -eps

    # ---- ftran + ratio test (+ eta and the stepped x_b) ----
    A_p = backend.gather_column(prob.A, p).to(dtype)
    c_p = backend.gather_cost(prob.c, p).to(dtype)
    e_p = torch.dot(state.y, A_p) - c_p  # == min_e under Dantzig
    alpha = torch.mv(state.B_inv, A_p)
    q, theta_q, unbounded, eta, x_b_new = backend.ratio_eta(
        state.x_b, alpha, state.basis, opts.pivot_tol, use_bland,
        opts.ratio == "harris", opts.feas_tol,
    )

    take = ~optimal & ~unbounded
    # numerical failure: a non-finite pricing value, or a pivot about to be
    # taken with a non-finite ratio
    bad = ~torch.isfinite(min_e) | (take & ~torch.isfinite(theta_q))
    take = take & ~bad

    alpha_q = alpha.index_select(0, q.view(1)).view(())
    inv_aq = 1 / torch.where(take, alpha_q, 1)
    theta_safe = torch.where(take, theta_q, 0)
    # row q of the OLD inverse, as a copy: the update below rewrites B_inv
    binv_q = state.B_inv.index_select(0, q.view(1)).view(-1)

    # ---- product-form rank-1 update, a no-op when not pivoting ----
    B_inv = backend.rank1_update(
        state.B_inv,
        torch.where(take, eta, 0),
        torch.where(take, binv_q, 0),
    )

    # ---- O(m) updates ----
    y_new = state.y - (e_p * inv_aq) * binv_q
    at_q = (torch.arange(state.basis.shape[0], device=q.device) == q) & take
    degen_new = torch.where(
        theta_safe <= opts.degen_tol, state.degen + 1, torch.zeros_like(state.degen)
    )
    status = torch.where(
        optimal,
        int(SolveStatus.OPTIMAL),
        torch.where(
            unbounded,
            int(SolveStatus.UNBOUNDED),
            torch.where(bad, int(SolveStatus.SINGULAR), int(SolveStatus.RUNNING)),
        ),
    ).to(torch.int32)
    return SolverState(
        B_inv=B_inv,
        x_b=torch.where(take, x_b_new, state.x_b),
        y=torch.where(take, y_new, state.y),
        c_b=torch.where(at_q, c_p, state.c_b),
        basis=torch.where(at_q, p, state.basis),
        iters=state.iters + take.to(torch.int32),
        status=status,
        degen=torch.where(take, degen_new, state.degen),
        last_refac=state.last_refac,
        pert=state.pert,
    )


def _effective_rhs(prob: Problem, state: SolverState, dtype) -> torch.Tensor:
    """The rhs the basic variables solve against: b, plus the active
    perturbation shift w."""
    b = prob.b.to(dtype)
    if state.pert is not None:
        b = b + state.pert.w.to(dtype)
    return b


def perturb_activate(
    prob: Problem, state: SolverState, backend, scale: float
) -> SolverState:
    """Arm (or re-arm) the anti-degeneracy rhs perturbation: shift x_b by a
    deterministic delta > 0 and accumulate w += B delta, so B x_b = b + w
    stays exact and every later ratio has a positive numerator.

    The multipliers are computed in the state dtype, as the JAX package
    does, so both packages shift by the same amounts.
    """
    dtype = state.x_b.dtype
    m = state.x_b.shape[0]
    r = 0.5 + torch.remainder(
        torch.arange(m, dtype=dtype, device=state.x_b.device) * 0.6180339887498949
        + 0.137,
        1.0,
    )
    delta = scale * (1 + state.x_b.abs()) * r
    B = backend.gather_basis_matrix(prob.A, state.basis).to(dtype)
    w = B @ delta
    pert = state.pert
    return dataclasses.replace(
        state,
        x_b=state.x_b + delta,
        degen=torch.zeros_like(state.degen),
        pert=dataclasses.replace(
            pert,
            w=pert.w + w,
            on=torch.ones_like(pert.on),
            rounds=pert.rounds + 1,
        ),
    )


def perturb_scale(opts: SimplexOptions, rounds: int) -> float:
    """Shift scale of activation number ``rounds``: perturb_scale *
    perturb_grow^min(rounds, 4), rounded in float32 like the JAX package."""
    scale = np.float32(opts.perturb_scale)
    if opts.perturb_grow != 1.0:
        scale = scale * np.float32(opts.perturb_grow) ** np.float32(min(rounds, 4))
    return float(np.float32(scale))


def perturb_clear(state: SolverState) -> SolverState:
    """Drop the rhs shift. The caller must refactorize or recompute_xy next:
    x_b still holds the shifted point until it is re-derived."""
    pert = state.pert
    return dataclasses.replace(
        state,
        pert=dataclasses.replace(
            pert, w=torch.zeros_like(pert.w), on=torch.zeros_like(pert.on)
        ),
    )


def refactorize(prob: Problem, state: SolverState, backend) -> SolverState:
    """Re-invert the true basis (Newton-Schulz seeded with the drifted
    inverse) and re-derive x_b and y from it."""
    dtype = state.B_inv.dtype
    B = backend.gather_basis_matrix(prob.A, state.basis).to(dtype)
    B_inv, _ = inverse_newton(B, seed=state.B_inv)
    return dataclasses.replace(
        state,
        B_inv=B_inv,
        # no clamp: x_b must stay the exact basic solution
        x_b=B_inv @ _effective_rhs(prob, state, dtype),
        y=state.c_b @ B_inv,
        last_refac=state.iters.clone(),
    )


def recompute_xy(prob: Problem, state: SolverState) -> SolverState:
    """Refresh x_b and y from the current inverse (two O(m^2) products)."""
    dtype = state.B_inv.dtype
    return dataclasses.replace(
        state,
        x_b=state.B_inv @ _effective_rhs(prob, state, dtype),
        y=state.c_b @ state.B_inv,
    )
