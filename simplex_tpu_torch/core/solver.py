"""The solve loop: a host loop around the pivot step.

The counterpart of ``simplex_tpu.core.solver``, whose pivot loop is one
``lax.while_loop`` on the device. Here the loop runs in Python and reads
the control scalars (status, iters, degen, last_refac, the perturbation
state and the next step's branch flags, :func:`step.read_control`) back
from the device once per pivot, as one small tensor; a step may add
explicit reads of its own (``step.host_reads``). Between pivots it arms the
rhs perturbation and runs the optional periodic recompute /
refactorization, re-reading the control after any of them; after the loop,
the verify-terminal rounds re-check every terminal decision against a
re-inverted basis. The returned basis is then polished in float64 on the
same device. A state the loop returns shares no memory with the buffers of
the backend's step graphs (:mod:`simplex_tpu_torch.core.graph`). Where
those graphs replay the default step, the loop enqueues the step after a
replay before it reads that replay's control (:func:`may_run_ahead`), so
the card does not wait on the read and the host between steps. While
spans are recorded (:mod:`simplex_tpu_torch.spans`), the solve, each pivot,
the upkeep, the verify rounds and the polish are host spans.

A sparse A (scipy.sparse, or a :class:`~simplex_tpu_torch.sparse.SparseA`)
stays sparse on the device: every op that reads A dispatches on it, the
pivot loop is the same, and the polish takes A's basis columns from the
matrix's float64 host copy.
"""

from __future__ import annotations

import dataclasses
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
from simplex_tpu_torch.core.state import (
    Problem,
    SolverState,
    initial_state,
    initial_state_slack,
    problem_from_numpy,
    with_pricing_shadow,
)
from simplex_tpu_torch.core.step import (
    Control,
    bland_on,
    perturb_activate,
    perturb_clear,
    perturb_scale,
    pivot_step,
    read_control,
    recompute_xy,
    refactorize,
)
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.logging import get_logger
from simplex_tpu_torch.status import SolveStatus

MAX_VERIFY_ROUNDS = 4
MAX_PERTURB_ROUNDS = 16

_log = get_logger("solver")


class SolveResult(NamedTuple):
    """Host-side result; the same fields as ``simplex_tpu.SolveResult``."""

    z: float
    x: np.ndarray  # (n,) full primal solution
    x_b: np.ndarray  # (m,)
    basis: np.ndarray  # (m,) int32
    status: SolveStatus
    iters: int
    # worst primal infeasibility of the returned basis, below 0 or above u
    # (exact f64 when the polish ran)
    feas_err: float = 0.0
    y: Optional[np.ndarray] = None  # (m,) simplex multipliers
    at_upper: Optional[np.ndarray] = None  # (n,) bounded solves only


def _upkeep_due(opts: SimplexOptions, iters: int, degen: int, pert_rounds: int) -> tuple:
    """The upkeep due before the step from a state with these control words,
    in the loop's order: ``"perturb"`` (degen a positive multiple of
    ``perturb_after``, rounds left; whether the state carries the
    perturbation is the caller's test), ``"recompute"``, ``"refactorize"``
    (iters a positive multiple of their period)."""
    due = ()
    pa = opts.perturb_after
    if pa > 0 and pert_rounds < MAX_PERTURB_ROUNDS and degen >= pa and degen % pa == 0:
        due = ("perturb",)
    if iters > 0:
        if opts.recompute_every > 0 and iters % opts.recompute_every == 0:
            due += ("recompute",)
        if opts.refactor_every > 0 and iters % opts.refactor_every == 0:
            due += ("refactorize",)
    return due


def may_run_ahead(ctl: Control, opts: SimplexOptions, max_iter: int, replayed: bool) -> bool:
    """Whether the loop may enqueue the step from s_{k+1} before it reads
    s_{k+1}'s control, knowing only ``ctl`` (s_k's) and ``replayed``: step k
    ran as a graph replay, and the step from its output would replay a graph
    of the same key already captured (:meth:`~simplex_tpu_torch.core.graph.
    StepGraphs.ready`).

    A step moves iters and degen by at most +1 (degen otherwise back to 0)
    and leaves the perturbation's rounds, so the step from s_{k+1} is the
    serial loop's when, for either value, it stays within ``max_iter``,
    Bland's rule stays off and no upkeep falls due (:func:`_upkeep_due`).
    The host cannot foresee the status; a step from an OPTIMAL, UNBOUNDED
    or SINGULAR state re-derives the same decision and leaves the state as
    it is (zero eta and row, iters and degen kept), so the loop still ends
    where the serial one does."""
    if not replayed or ctl.status != SolveStatus.RUNNING or ctl.iters + 2 > max_iter:
        return False
    degen = ctl.degen + 1
    return not (
        bland_on(opts, degen)
        or _upkeep_due(opts, ctl.iters, degen, ctl.pert_rounds)
        or _upkeep_due(opts, ctl.iters + 1, degen, ctl.pert_rounds)
    )


def _pivot_loop(prob, s, ctl, opts, max_iter, backend):
    perturb = opts.perturb_after > 0 and s.pert is not None
    defer = opts.resolve_defer() > 0
    graphs = getattr(backend, "step_graphs", None)
    ahead = None  # the step from s, enqueued before s's control was read
    while ctl.status == SolveStatus.RUNNING and ctl.iters < max_iter:
        span = spans.start_pivot(ctl.iters)
        new = pivot_step(prob, s, opts, backend, ctl) if ahead is None else ahead
        ahead = None
        if graphs is not None and may_run_ahead(ctl, opts, max_iter, graphs.ready(prob, new, opts)):
            # iters and degen at the most this step can have made them: the
            # step from new reads them only for Bland's rule, off for either
            guess = ctl._replace(iters=ctl.iters + 1, degen=ctl.degen + 1)
            ahead = pivot_step(prob, new, opts, backend, guess)
        s = new
        ctl = read_control(s, opts, prob, backend)
        touched = False
        if ctl.status == SolveStatus.RUNNING:
            for kind in _upkeep_due(opts, ctl.iters, ctl.degen, ctl.pert_rounds):
                if kind == "perturb" and not perturb:
                    continue
                up = spans.start("maintain", kind)
                if kind == "perturb":
                    s = perturb_activate(prob, s, backend, perturb_scale(opts, ctl.pert_rounds))
                elif kind == "recompute":
                    s = recompute_xy(prob, s, defer)
                else:
                    s = refactorize(prob, s, backend, defer, opts.pricing)
                spans.stop(up)
                touched = True
        if touched:
            # the next step branches on the state as it is now
            ctl = read_control(s, opts, prob, backend)
        spans.stop(span)
    if graphs is not None:
        # no state leaves the loop in the step graphs' buffers
        s = graphs.detach(s)
    return s, ctl


def solve_state(
    prob: Problem,
    state0: SolverState,
    opts: SimplexOptions,
    max_iter: int,
    backend=None,
) -> SolverState:
    """Run the pivot loop to termination, then the verify rounds; maps a
    still-running status to MAX_ITER."""
    if backend is None:
        backend = get_backend(opts.backend)
    root = spans.start_solve()
    try:
        return _solve_state(prob, state0, opts, max_iter, backend)
    finally:
        spans.stop(root)


def _solve_state(prob, state0, opts, max_iter, backend):
    perturb = opts.perturb_after > 0 and state0.pert is not None
    defer = opts.resolve_defer() > 0
    ctl = read_control(state0, opts, prob, backend)
    s, ctl = _pivot_loop(prob, state0, ctl, opts, max_iter, backend)

    if opts.verify_terminal:
        # a terminal decision made from a drifted product-form inverse (or
        # for the perturbed rhs) is re-checked from an exact inverse
        rounds = 0
        while (
            rounds < MAX_VERIFY_ROUNDS
            and ctl.status != SolveStatus.RUNNING
            and ctl.iters < max_iter
            and (ctl.iters > ctl.last_refac or (perturb and ctl.pert_on))
        ):
            span = spans.start("verify")
            if perturb and ctl.pert_on:
                s = perturb_clear(s)
            s = refactorize(prob, s, backend, defer, opts.pricing)
            s.status = torch.full_like(s.status, int(SolveStatus.RUNNING))
            ctl = read_control(s, opts, prob, backend)
            s, ctl = _pivot_loop(prob, s, ctl, opts, max_iter, backend)
            spans.stop(span)
            rounds += 1

    if perturb and ctl.pert_on:
        # exits that leave the shift armed (MAX_ITER, verify off, rounds
        # exhausted): re-derive x_b / y from the true rhs
        s = recompute_xy(prob, perturb_clear(s), defer)

    if ctl.status == SolveStatus.RUNNING:
        s.status = torch.full_like(s.status, int(SolveStatus.MAX_ITER))
    return s


def build_problem(A, b, c, options: SimplexOptions, device, u_np=None) -> Problem:
    """The device problem a solve runs on (``simplex_tpu.core.solver.solve``'s
    set-up): A dense or sparse in ``options.dtype``; the pricing shadow
    (bfloat16 for a dense A; under ``pricing_sparse`` a float32 sparse copy
    of a dense A); and for a sparse A under segmented Dantzig pricing the
    column segments, built when S divides n and n / S >=
    ``partial_min_segment`` (else the full pass prices, as for dense A)."""
    dtype = options.dtype
    prob = problem_from_numpy(A, b, c, device, dtype, u=u_np)
    sparse = isinstance(prob.A, _sp.SparseA)
    dantzig = options.pricing == "dantzig"
    if options.pricing_sparse and dantzig and not sparse:
        if options.partial_pricing > 1:
            raise NotImplementedError(
                "pricing_sparse needs the full-shadow pass; segmented "
                "pricing (partial_pricing) slices dense arrays"
            )
        return dataclasses.replace(prob, A_price=_sp.from_dense(A, torch.float32, device))
    prob = with_pricing_shadow(prob, options.pricing_dtype, options.pricing)
    S, n = options.partial_pricing, prob.A.shape[1]
    if sparse and dantzig and S > 1 and n % S == 0 and n // S >= options.partial_min_segment:
        prob = dataclasses.replace(prob, A_segs=_sp.split_columns(prob.A, S))
    return prob


def solve(
    A,
    b,
    c,
    *,
    u=None,
    basis0: Optional[np.ndarray] = None,
    at_upper0: Optional[np.ndarray] = None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    device="cuda",
) -> SolveResult:
    """Solve  max c.x  s.t.  A x = b, 0 <= x (<= u)  from a feasible basis,
    on ``device`` (default ``"cuda"``; there is no fallback to the CPU).

    ``basis0=None`` starts from the trailing identity slack block. ``A``
    (a dense numpy array or tensor; sparse: scipy.sparse, a sparse tensor
    or a :class:`~simplex_tpu_torch.sparse.SparseA`) is moved to
    ``device`` and cast to ``options.dtype``, with its pricing shadow beside
    it when ``options.pricing_dtype`` or ``pricing_sparse`` asks for one.
    ``u`` ((n,), +inf for a column without a bound) selects the
    bounded-variable rule; ``at_upper0`` marks the nonbasic columns that
    start at their upper bound. A ``u`` with no finite entry takes the
    unbounded path.
    """
    options = check_supported(options)
    if not isinstance(A, torch.Tensor) and not _sp.is_sparse(A):
        A = np.asarray(A)
    b, c = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in (b, c))
    if A.ndim != 2:
        raise ValueError(f"A must be a matrix, got shape {A.shape}")
    m, n = A.shape
    if m > n:
        raise ValueError(f"m > n ({m} > {n}): not a canonical-form LP")
    if b.shape != (m,) or c.shape != (n,):
        raise ValueError(f"shape mismatch: A {A.shape}, b {b.shape}, c {c.shape}")
    u_np = None
    if u is not None:
        u_np = np.asarray(u.cpu() if isinstance(u, torch.Tensor) else u, np.float64)
        if u_np.shape != (n,):
            raise ValueError(f"u shape {u_np.shape} != ({n},)")
        if np.any(u_np < 0):
            raise ValueError("negative upper bound (shift lowers to 0 first)")
        if not np.any(np.isfinite(u_np)):
            u_np = None  # all-inf bounds: the unbounded path

    pin_full_fp32()
    device = torch.device(device)
    dtype = options.dtype
    prob = build_problem(A, b, c, options, device, u_np)
    extras = dict(
        perturb=options.perturb_after > 0,
        update_defer=options.resolve_defer(),
        multi_price=options.multi_price,
        at_upper0=at_upper0 if u_np is not None else None,
        pricing=options.pricing,
    )
    if basis0 is None:
        state0 = initial_state_slack(prob, dtype, **extras)
    else:
        state0 = initial_state(prob, basis0, dtype, **extras)
    final = solve_state(prob, state0, options, options.resolve_max_iter(m, n))
    return finalize_result(prob, b, c, final, options, u_np)


def basis_columns64(A, basis: torch.Tensor) -> torch.Tensor:
    """A[:, basis] in float64 on A's device: from the device A when dense,
    from the float64 host copy when sparse (``_host_basis_cols``)."""
    if isinstance(A, _sp.SparseA):
        cols = _sp.gather_columns_host(A, basis.cpu().numpy())
        return torch.as_tensor(cols, device=A.device)
    return A.index_select(1, basis.to(A.device)).double()


def _polish_refine(A_B, b64, x_b0, precondition, iters: int = 4):
    """f64 x_b for the final basis by iterative refinement on the device:
    r = b - A_B x in float64 (``A_B`` the basis columns in float64), x +=
    ``precondition(r)``, the solve's fp32 inverse applied to r. Keeps the
    best iterate. Returns (x64, residual)."""
    x = x_b0.double()
    best_x, best_nr = x, torch.full((), float("inf"), dtype=torch.float64, device=x.device)
    for it in range(iters + 1):
        r = b64 - A_B @ x
        nr = r.abs().max()
        better = nr < best_nr
        best_x = torch.where(better, x, best_x)
        best_nr = torch.where(better, nr, best_nr)
        if it < iters:
            x = x + precondition(r)
    return best_x, best_nr.item()


def finalize_result(
    prob: Problem, b, c, final: SolverState, options: SimplexOptions, u_np=None,
    basis_columns=basis_columns64, precondition=None,
) -> SolveResult:
    """Pull the result to the host and polish the returned basis in f64.

    Bounded solves (``u_np``) fold the nonbasic-at-upper columns in: the
    basis solves against b_eff = b - A_up u_up, z gains c_up . u_up, x
    carries u at those columns, and feas_err counts excess over u too.
    ``basis_columns(A, idx)`` gives A's columns ``idx`` in float64 (a
    column-sharded solve gathers them from the ranks that own them);
    ``precondition(r)`` applies the solve's inverse to an f64 residual
    (default: ``final.B_inv`` with the pending pairs folded in; the 2-D
    solve applies its row-sharded inverse)."""
    span = spans.start("polish")
    try:
        return _finalize_result(prob, b, c, final, options, u_np, basis_columns, precondition)
    finally:
        spans.stop(span)


def _finalize_result(prob, b, c, final, options, u_np, basis_columns, precondition):
    x_b_np = final.x_b.cpu().numpy()
    basis_np = final.basis.cpu().numpy()
    c_b_np = final.c_b.cpu().numpy()
    y_np = final.y.cpu().numpy()
    status = SolveStatus(int(final.status))
    iters = int(final.iters)
    m, n = len(basis_np), np.asarray(c).shape[0]
    c64 = np.asarray(c, np.float64)
    b64 = torch.as_tensor(np.asarray(b, np.float64), device=prob.A.device)

    at_upper_np, up_cols, ub_basic, z_fixed = None, None, None, 0.0
    if u_np is not None:
        at_upper_np = final.at_upper.cpu().numpy().copy()
        at_upper_np[basis_np] = False  # the invariant, restated
        up_cols = np.flatnonzero(at_upper_np)
        if len(up_cols):
            idx = torch.as_tensor(up_cols, device=prob.A.device)
            u_up = torch.as_tensor(u_np[up_cols], device=prob.A.device)
            b64 = b64 - basis_columns(prob.A, idx) @ u_up
            z_fixed = float(c64[up_cols] @ u_np[up_cols])
        ub_basic = u_np[basis_np]

    def bounded_feas(x_vals) -> float:
        err = max(0.0, float(-x_vals.min())) if m else 0.0
        if ub_basic is not None:
            err = max(err, float(np.max(x_vals - ub_basic, initial=0.0)))
        return err

    z = float(np.dot(c_b_np, x_b_np)) + z_fixed
    feas_err = bounded_feas(x_b_np)
    if options.polish and m <= options.polish_max_m:
        # exact values for the returned basis, no clamping: a violation is
        # reported as feas_err, not zeroed
        if precondition is None:
            B_inv = final.B_inv
            if final.U is not None:
                # precondition with the true inverse, pending pairs folded in
                B_inv = torch.addmm(B_inv, final.U.T, final.R)

            def precondition(r):
                return (B_inv @ r.to(B_inv.dtype)).double()

        A_B = basis_columns(prob.A, final.basis)
        x64, nr = _polish_refine(A_B, b64, final.x_b, precondition)
        scale = max(1.0, float(b64.abs().max())) if m else 1.0
        ok = np.isfinite(nr) and nr <= 1e-7 * scale
        if not ok:
            _log.warning(
                "polish refinement stalled (ill-conditioned basis); "
                "falling back to an f64 LU solve"
            )
            try:
                x64 = torch.linalg.solve(A_B, b64)
                ok = True
            except torch.linalg.LinAlgError:
                ok = False
        if ok:
            x_b64 = x64.cpu().numpy()
            feas_err = bounded_feas(x_b64)
            x_b_np = x_b64.astype(x_b_np.dtype)
            z = float(c64[basis_np] @ x_b64) + z_fixed
    x = np.zeros(n, dtype=x_b_np.dtype)
    if up_cols is not None:
        x[up_cols] = u_np[up_cols].astype(x_b_np.dtype)
    x[basis_np] = x_b_np
    return SolveResult(
        z=z,
        x=x,
        x_b=x_b_np,
        basis=basis_np,
        status=status,
        iters=iters,
        feas_err=feas_err,
        y=y_np,
        at_upper=at_upper_np,
    )
