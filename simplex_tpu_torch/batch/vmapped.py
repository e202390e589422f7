"""Batched solves: many same-shape LPs at once on one device.

The counterpart of ``simplex_tpu.batch.vmapped`` with its names, fields
and statuses. JAX vmaps its whole solve; here the batch axis is written out
(:mod:`simplex_tpu_torch.batch.step`, :mod:`simplex_tpu_torch.batch.dual`):
one batch step pivots every running instance at once through three batched
Hopper kernels (pricing, the pivot's tail, the rank-1 update) with one
control read, and a finished instance is left as it is. Every pricing rule
of the single solve runs batched: Dantzig over A, the bf16 shadow or a
column segment (``partial_pricing``), devex and steepest edge.

  solve_batched        B independent LPs (A (B, m, n), b (B, m), c (B, n)),
                       each from its slack basis; optional bounds u (n,)
                       shared by the batch
  reoptimize_batched   B rhs scenarios (b (B, m)) re-solved from ONE prior
                       optimal basis of a shared (A, c): the batched dual
                       loop, then the primal clean-up

Given ``mesh=`` (a :class:`~torch.distributed.device_mesh.DeviceMesh`),
the batch is split over the ranks of its axis ``batch_axis`` (pure data
parallelism, as the JAX package shards the vmapped batch): each rank
solves its ``tensor_split`` slice of the instances (or scenarios) on its
own device, and the per-instance results are all-gathered, so every rank
returns the whole batch's result.

Both run in float32 or float64 (``options.dtype``), through the same three
kernels. Neither runs the f64 polish: z comes from the solve in its
working dtype, and ``reoptimize_batched`` reports each scenario's feas_err
= max(-min x_b, 0).
Use the single :func:`~simplex_tpu_torch.solve` for audited final numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.batch import dual as _bd
from simplex_tpu_torch.batch import step as _bs
from simplex_tpu_torch.config import (
    DEFAULT_OPTIONS,
    SimplexOptions,
    check_supported,
    pin_full_fp32,
)
from simplex_tpu_torch.core.dual import _entry_dual_feasibility
from simplex_tpu_torch.core.state import Problem
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.logging import get_logger
from simplex_tpu_torch.status import SolveStatus


class BatchSolveResult(NamedTuple):
    z: np.ndarray  # (B,)
    x_b: np.ndarray  # (B, m)
    basis: np.ndarray  # (B, m)
    status: np.ndarray  # (B,) int32
    iters: np.ndarray  # (B,) int32
    # worst primal lower-bound violation per instance (working dtype; no polish):
    # None from solve_batched, filled by reoptimize_batched
    feas_err: Optional[np.ndarray] = None

    def statuses(self):
        return [SolveStatus(int(s)) for s in self.status]


def _prepare(options: SimplexOptions, what: str) -> SimplexOptions:
    options = check_supported(options)
    if options.multi_price > 0:
        # as in the JAX package: the batched state has no candidate buffer
        get_logger("batch").warning(
            "multi_price=%d is inert in solve_batched (single-chip dantzig "
            "only); solving without multiple pricing", options.multi_price
        )
    if options.pricing_sparse:
        # as in the JAX package: its batched paths build no sparse shadow
        # (only the single solve reads the option)
        get_logger("batch").warning(
            "pricing_sparse is inert in %s (the batched paths build no sparse "
            "shadow); pricing the dense A", what
        )
    return options


def _shadow(prob: Problem, options: SimplexOptions) -> Problem:
    """The bf16 pricing shadow of a dense A, under the Dantzig rule only
    (``simplex_tpu.core.state.with_pricing_shadow``: devex and steepest
    edge never read it)."""
    if options.pricing_dtype != "float32" and options.pricing == "dantzig" and not _sp.is_sparse(prob.A):
        prob.A_price = prob.A.to(getattr(torch, options.pricing_dtype)).contiguous()
    return prob


def _bounds(u, n: int, device, dtype):
    if u is None:
        return None
    u_np = np.asarray(u.cpu() if isinstance(u, torch.Tensor) else u, np.float64)
    if u_np.shape != (n,):
        raise ValueError(f"u shape {u_np.shape} != ({n},)")
    if np.any(u_np < 0):
        raise ValueError("negative upper bound (shift lowers to 0 first)")
    return torch.as_tensor(u_np, device=device).to(dtype)


def _array(v):
    """``v`` as it is when a tensor (no host round trip: a tensor already on
    the solve's device is used in place), else a numpy array."""
    return v if isinstance(v, torch.Tensor) else np.asarray(v)


def _over_mesh(mesh, batch_axis: str, Bn: int, solve_slice) -> BatchSolveResult:
    """``solve_slice(lo, hi)`` on this rank's ``tensor_split`` slice of the
    Bn instances, then every rank's results all-gathered in rank order. An
    error on any rank is gathered too and raised on every rank, so that no
    rank waits for one that gave up."""
    import torch.distributed as dist

    from simplex_tpu_torch.dist.mesh import require_mesh

    group = require_mesh(mesh).get_group(batch_axis)
    ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    sizes = [len(s) for s in np.array_split(np.arange(Bn), ranks)]
    lo = sum(sizes[:rank])
    try:
        mine = solve_slice(lo, lo + sizes[rank]) if sizes[rank] else None
    except Exception as e:  # raised below, on every rank
        mine = e
    parts = [None] * ranks
    dist.all_gather_object(parts, mine, group=group)
    for p in parts:
        if isinstance(p, Exception):
            raise p
    parts = [p for p in parts if p is not None]

    def cat(field):
        vals = [getattr(p, field) for p in parts]
        return None if vals[0] is None else np.concatenate(vals)

    return BatchSolveResult(*(cat(f) for f in BatchSolveResult._fields))


def solve_batched(
    As,
    bs,
    cs,
    *,
    u=None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    mesh=None,
    batch_axis: str = "batch",
    device="cuda",
) -> BatchSolveResult:
    """Solve a stack of same-shape LPs: As (B, m, n), bs (B, m), cs (B, n),
    each  max c.x  s.t.  A x = b, 0 <= x (<= u)  from its trailing slack
    basis, on ``device`` (default ``"cuda"``; no fallback to the CPU). ``u``
    (optional (n,), shared by the batch) runs every instance under the
    native bounded-variable rule. A stack given as a tensor already on
    ``device`` in ``options.dtype`` is used in place (no host round trip).
    With ``mesh``, the instances are split over the ranks of its axis
    ``batch_axis`` (every rank of it calls this with the whole batch and
    returns the whole result)."""
    As, bs, cs = (_array(v) for v in (As, bs, cs))
    if mesh is not None:
        return _over_mesh(mesh, batch_axis, len(As), lambda lo, hi: solve_batched(
            As[lo:hi], bs[lo:hi], cs[lo:hi], u=u, options=options, device=device))
    options = _prepare(options, "solve_batched")
    if As.ndim != 3:
        raise ValueError(f"As must be (B, m, n), got {As.shape}")
    Bn, m, n = As.shape
    if bs.shape != (Bn, m) or cs.shape != (Bn, n):
        raise ValueError(f"shape mismatch: As {As.shape}, bs {bs.shape}, cs {cs.shape}")
    pin_full_fp32()
    device = torch.device(device)
    dtype = options.dtype

    def put(v):
        return torch.as_tensor(v, device=device).to(dtype).contiguous()

    prob = _shadow(Problem(A=put(As), b=put(bs), c=put(cs), u=_bounds(u, n, device, dtype)), options)
    s = _bs.batch_state_slack(prob, dtype, options.resolve_defer(), options.pricing)
    final = _bs.batch_solve_state(
        prob, s, options, options.resolve_max_iter(m, n), get_backend(options.backend)
    )
    z = _bs.objective(prob, final, dtype)
    return BatchSolveResult(
        z=z.cpu().numpy(),
        x_b=final.x_b.cpu().numpy(),
        basis=final.basis.cpu().numpy(),
        status=final.status.cpu().numpy(),
        iters=final.iters.cpu().numpy(),
    )


def reoptimize_batched(
    A,
    bs_new,
    c,
    prev,
    *,
    u=None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    mesh=None,
    batch_axis: str = "batch",
    device="cuda",
) -> BatchSolveResult:
    """Warm re-solve MANY rhs scenarios from one prior optimal basis, on
    ``device`` (default ``"cuda"``).

    ``bs_new`` is (B, m); ``prev`` is the SolveResult of the original solve
    (or a bare (m,) basis array; ``prev.at_upper`` carries the bounded
    flags). A (dense, scipy.sparse or a
    :class:`~simplex_tpu_torch.sparse.SparseA`) and c are shared; a dense A,
    ``bs_new`` or c given as a tensor already on ``device`` in
    ``options.dtype`` is used in place (no host round trip). Entry dual
    feasibility is checked once, in float64 on the device. Each scenario
    runs the dual simplex from the shared basis, then the primal loop
    certifies optimality; statuses are per scenario (an INFEASIBLE scenario
    does not poison the batch). No f64 polish: ``feas_err`` is each
    scenario's max(-min x_b, 0). With ``mesh``, the scenarios are split
    over the ranks of its axis ``batch_axis``, as in :func:`solve_batched`."""
    if mesh is not None:
        bs_new = _array(bs_new)
        return _over_mesh(mesh, batch_axis, len(bs_new), lambda lo, hi: reoptimize_batched(
            A, bs_new[lo:hi], c, prev, u=u, options=options, device=device))
    options = _prepare(options, "reoptimize_batched")
    sparse = _sp.is_sparse(A)
    if not sparse:
        A = _array(A)
    bs_new, c = _array(bs_new), _array(c)
    m, n = A.shape
    if bs_new.ndim != 2 or bs_new.shape[1] != m:
        raise ValueError(f"bs_new must be (B, {m}), got {bs_new.shape}")
    if c.shape != (n,):
        raise ValueError(f"c shape {c.shape} != ({n},)")
    basis0 = np.asarray(getattr(prev, "basis", prev), np.int32)
    at_upper0 = getattr(prev, "at_upper", None)
    device = torch.device(device)
    tol = 10 * options.resolve_eps()
    u_np = None if u is None else np.asarray(u.cpu() if isinstance(u, torch.Tensor) else u, np.float64)
    min_e = _entry_dual_feasibility(
        A, c, basis0, at_upper0 if u is not None else None, u_np, device
    )
    if min_e < -tol:
        raise ValueError(
            f"entry basis is not dual-feasible (min signed reduced cost "
            f"{min_e:.3g} < {-tol:.3g}); reoptimize_batched requires the "
            "basis of a prior OPTIMAL solve of the same (A, c)"
        )
    pin_full_fp32()
    dtype = options.dtype
    A_dev = (
        _sp.as_sparse(A, dtype, device) if sparse
        else torch.as_tensor(A, device=device).to(dtype).contiguous()
    )

    def put(v):
        return torch.as_tensor(v, device=device).to(dtype).contiguous()

    prob = _shadow(Problem(A=A_dev, b=put(bs_new), c=put(c), u=_bounds(u, n, device, dtype)), options)
    s = _bs.batch_state_from_basis(
        prob, basis0, dtype, at_upper0 if u is not None else None, options.resolve_defer(),
        options.pricing,
    )
    final = _bd.warm_solve_state(
        prob, s, options, options.resolve_max_iter(m, n), get_backend(options.backend)
    )
    z = _bs.objective(prob, final, dtype)
    feas = torch.clamp_min(-final.x_b.min(1).values, 0)
    return BatchSolveResult(
        z=z.cpu().numpy(),
        x_b=final.x_b.cpu().numpy(),
        basis=final.basis.cpu().numpy(),
        status=final.status.cpu().numpy(),
        iters=final.iters.cpu().numpy(),
        feas_err=feas.cpu().numpy(),
    )
