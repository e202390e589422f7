"""Per-pivot trace: ``simplex_tpu.core.trace`` on the port.

The same pivot step as ``solve`` (:func:`~simplex_tpu_torch.core.step.
pivot_step`, or the dual step), driven one pivot at a time with a record of
each transition: use it on small instances to check a pivot path by hand, or
to diff two backends' paths. ``solve`` itself is untouched: the trace is
its own loop, so it adds no read to a solve.

Each record is made of host copies (numpy) taken right after its step: the
step rewrites B_inv, U and R in place, so a record never refers to device
memory.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Iterator, List, Optional, TextIO

import numpy as np
import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.config import (
    DEFAULT_OPTIONS,
    SimplexOptions,
    check_supported,
    pin_full_fp32,
)
from simplex_tpu_torch.core.state import initial_state, initial_state_slack, problem_from_numpy
from simplex_tpu_torch.core.step import _const_flag, pivot_step
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.status import SolveStatus


@dataclasses.dataclass
class PivotRecord:
    iteration: int
    entering: int  # column p entering the basis (-1 once terminal)
    leaving_row: int  # row q whose variable leaves (-1 once terminal)
    leaving: int  # column index that left the basis (-1 once terminal)
    min_reduced_cost: float
    theta: float
    objective: float
    status: SolveStatus
    basis: np.ndarray
    x_b: np.ndarray
    B_inv: Optional[np.ndarray] = None  # after the step, when asked for


def trace_pivots(
    A,
    b,
    c,
    *,
    basis0=None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    max_iter: Optional[int] = None,
    dual: bool = False,
    keep_inverse: bool = False,
    device="cuda",
) -> Iterator[PivotRecord]:
    """Yield one :class:`PivotRecord` per pivot until termination, on
    ``device`` (default ``"cuda"``; there is no fallback to the CPU).

    The executed pivot is read off the basis transition, so the record is
    right whatever rule picked the column. ``min_reduced_cost`` is the
    exact masked Dantzig minimum of the pre-pivot duals (one
    ``choose_entering`` call: the pricing kernel on dense A, the SpMV on
    sparse A). As in the JAX package, ``update_defer`` and ``multi_price``
    are set to 0 (a candidate buffer would change the path; the trace
    reports the single-candidate walk of the same rule), and the problem
    carries no pricing shadow and no perturbation.

    ``dual=True`` traces the dual step from ``basis0`` (a dual-feasible
    basis): ``min_reduced_cost`` is then the pre-pivot worst primal
    violation and ``theta`` the entering variable's new value; OPTIMAL
    means primal feasibility. ``keep_inverse`` adds a host copy of B_inv
    (m x m) to every record.

    ``A`` may be sparse (scipy.sparse or a
    :class:`~simplex_tpu_torch.sparse.SparseA`); segmented pricing
    (``partial_pricing > 1``) is refused there, as in the JAX package."""
    options = check_supported(options)
    if _sp.is_sparse(A) and options.partial_pricing > 1:
        # a trace must run the requested pricing path
        raise NotImplementedError(
            "segmented pricing slices dense column ranges; trace sparse A "
            "with partial_pricing=0"
        )
    if options.update_defer or options.multi_price:
        options = dataclasses.replace(options, update_defer=0, multi_price=0)
    if not isinstance(A, torch.Tensor) and not _sp.is_sparse(A):
        A = np.asarray(A)
    pin_full_fp32()
    device = torch.device(device)
    dtype = options.dtype
    b, c = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in (b, c))
    prob = problem_from_numpy(A, b, c, device, dtype)
    backend = get_backend(options.backend)
    m, n = prob.A.shape
    if basis0 is None:
        state = initial_state_slack(prob, dtype, pricing=options.pricing)
    else:
        state = initial_state(prob, basis0, dtype, pricing=options.pricing)
    limit = max_iter if max_iter is not None else options.resolve_max_iter(m, n)
    eps = options.resolve_eps()
    no_bland = _const_flag(device, False)
    if dual:
        from simplex_tpu_torch.core.dual import dual_pivot_step

        step = dual_pivot_step
    else:
        step = pivot_step

    prev_basis = state.basis.cpu().numpy().copy()
    for it in range(limit):
        if dual:
            # the dual loop's progress measure: the worst primal violation
            # of the pre-pivot point
            min_e = (-state.x_b).clamp_min(0).max()
        else:
            min_e = backend.choose_entering(state.y, prob.A, prob.c, eps, no_bland, state.basis)[1]
        state = step(prob, state, options, backend)
        status = SolveStatus(int(state.status))
        terminal = status != SolveStatus.RUNNING
        # copies: on a CPU device .numpy() would share the tensor's memory
        new_basis = state.basis.cpu().numpy().copy()
        x_b = state.x_b.cpu().numpy().copy()
        changed = np.flatnonzero(new_basis != prev_basis)
        if len(changed) and not terminal:
            q = int(changed[0])
            p, leaving = int(new_basis[q]), int(prev_basis[q])
            theta = float(x_b[q])  # x_b_new[q] = theta
        else:
            q = p = leaving = -1
            theta = float("nan")
        yield PivotRecord(
            iteration=it + 1,
            entering=p,
            leaving_row=q,
            leaving=leaving,
            min_reduced_cost=float(min_e),
            theta=theta,
            objective=float(torch.dot(state.c_b, state.x_b)),
            status=status,
            basis=new_basis,
            x_b=x_b,
            B_inv=state.B_inv.cpu().numpy().copy() if keep_inverse else None,
        )
        if terminal:
            return
        prev_basis = new_basis


def print_trace(
    A, b, c, *, file: Optional[TextIO] = None, verbose: bool = False, **kwargs
) -> List[PivotRecord]:
    """Print a human-readable pivot trace to ``file`` (standard output when
    None); ``kwargs`` go to :func:`trace_pivots`."""
    file = sys.stdout if file is None else file
    records = []
    for r in trace_pivots(A, b, c, **kwargs):
        print(f"# Iteration {r.iteration}", file=file)
        if r.status == SolveStatus.RUNNING or r.entering >= 0:
            print(
                f"\tentering x_{r.entering}  leaving x_{r.leaving} (row {r.leaving_row})"
                f"  min_e={r.min_reduced_cost:+.6g}  theta={r.theta:.6g}"
                f"  z={r.objective:.6g}",
                file=file,
            )
        if verbose:
            print(f"\tbasis: {r.basis.tolist()}", file=file)
            print(f"\tx_b:   {np.round(r.x_b, 4).tolist()}", file=file)
        if r.status != SolveStatus.RUNNING:
            print(f"-> {r.status.describe()}", file=file)
        records.append(r)
    return records
