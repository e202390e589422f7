"""The batched pivot step and solve loop: B same-shape LPs at once.

The JAX package batches by ``jax.vmap`` over its solve
(``simplex_tpu.batch.vmapped``): every ``lax.cond`` of the step becomes a
select, and the ``while_loop`` runs until the last instance ends, with a
finished instance a no-op. Here the batch axis is written out: the state is
a :class:`~simplex_tpu_torch.core.state.SolverState` whose leaves carry a
leading axis B (B_inv (B, m, m), x_b (B, m), iters (B,), ...), and the loop
runs on the host with ONE control read a batch step (whether any instance
is still running, and what the next maintenance needs), never one an
instance. An instance is *active* while its status is RUNNING and it is
under the pivot limit; every leaf of an inactive instance is left bit for
bit (``torch.where`` per instance where the JAX step has ``lax.cond``).

One primal batch step, the Dantzig rule:

  pricing   e = y.A - c with the basic columns masked, per instance:
            ``choose_entering_batched`` (the batched pricing kernel on the
            hopper backend, for a per-instance A, fp32 or its bf16 shadow,
            and for the shared dense A of the warm re-solve; a shared
            sparse A is one SpMM and the masked choice). The shadow's
            winners are rechecked exactly; when any active instance's
            fails, one exact pass prices the batch and those instances take
            its pick (one counted branch read)
  ftran     alpha = B_inv A_p as one batched product (+ U^T (R A_p))
  tail      unbounded: ``pivot_tail_batched`` (one launch of the batched
            tail kernel); bounded (u shared by the batch): the two-sided
            test and its selects as plain ops, as in the single step
  update    eager: ``rank1_update_batched`` (one launch; it reads each
            instance's take flag on the device); deferred: the pair goes
            into slot npend[i] of instance i, and the whole batch flushes
            B_inv += U^T R when the largest npend (from the control read)
            reaches L - 1

``refactor_every`` and ``recompute_every`` are per-instance masks: the due
instances re-invert through a batched Newton-Schulz (``core.linalg.
inverse_newton_batched``, on the due subset) or recompute x_b and y. The
verify rounds re-check each instance's terminal decision against a
re-inverted basis, at most four rounds an instance.

The JAX batched solve builds its state without the rhs perturbation
(``simplex_tpu/batch/vmapped.py:55``, ``initial_state_slack``'s
``perturb=False``), and so does this one: Bland's rule after
``bland_after`` degenerate pivots is the batch's anti-cycling device. No
batched path runs the f64 polish, as in JAX.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.config import SimplexOptions
from simplex_tpu_torch.core.linalg import inverse_newton_batched
from simplex_tpu_torch.core.state import Problem, SolverState
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.status import SolveStatus

MAX_VERIFY_ROUNDS = 4
RUNNING = int(SolveStatus.RUNNING)

# device-to-host reads since the last reset: "control" (one a batch step),
# "branch" (the shadow's exact fallback), "maintenance" (the refactor and
# verify rounds': two a re-inversion, its Newton loop's per-iteration reads
# not counted)
host_reads = {"control": 0, "branch": 0, "maintenance": 0}
# batch steps taken since the last reset, by loop
steps = {"primal": 0, "dual": 0}


def reset_host_reads() -> None:
    """Zero the read and the step counters."""
    for d in (host_reads, steps):
        for k in d:
            d[k] = 0


def _read(ts, kind: str = "control") -> list:
    host_reads[kind] += 1
    return torch.stack([t.to(torch.int32) for t in ts]).tolist()


# --------------------------------------------------------------------------
# the batched problem and state
# --------------------------------------------------------------------------


# A as a batch holds it: per instance (B, m, n), or one matrix that every
# instance shares, dense (m, n) or a SparseA (the warm re-solve's). Every
# product and gather of the batched paths goes through the four helpers
# below; apart from them only ``_price`` tells the layouts apart (the
# pricing kernel reads both dense ones, and no kernel a sparse one).


def rmat(A, Y: torch.Tensor) -> torch.Tensor:
    """Y . A: row i of Y (B, m) against A[i] of a per-instance A; any (k, m)
    stack of rows against a shared A (one GEMM, or one SpMM over A^T)."""
    if isinstance(A, _sp.SparseA):
        return _sp.rmatmat(A, Y).to(Y.dtype)
    return _ops.rmat_batched(Y, A)


def matvec(A, X: torch.Tensor) -> torch.Tensor:
    """A[i] X[i] for every instance, (B, n) -> (B, m)."""
    if isinstance(A, _sp.SparseA):
        return _sp.matmat(A, X).to(X.dtype)
    if A.dim() == 2:
        return X @ A.to(X.dtype).T
    return torch.bmm(A.to(X.dtype), X[:, :, None])[:, :, 0]


def columns(A, idx: torch.Tensor) -> torch.Tensor:
    """A[i][:, idx[i]] for every instance, idx (B, k) -> (B, m, k)."""
    Bn, k = idx.shape
    if isinstance(A, _sp.SparseA):
        cols = _sp.gather_columns(A, idx.reshape(-1))
    elif A.dim() == 2:
        cols = A.index_select(1, idx.reshape(-1))
    else:
        return A.gather(2, idx.long()[:, None, :].expand(Bn, A.shape[1], k))
    return cols.view(-1, Bn, k).permute(1, 0, 2).contiguous()


def instances(A, idx: torch.Tensor):
    """A for the instances idx: their slices of a per-instance A; a shared
    A as it is."""
    if isinstance(A, _sp.SparseA) or A.dim() == 2:
        return A
    return A.index_select(0, idx)


def _dims(prob: Problem):
    return prob.A.shape[-2], prob.A.shape[-1]


def entering_columns(A, p: torch.Tensor) -> torch.Tensor:
    """A_p for every instance, (B, m): column p[i] of A[i] (or of the
    shared A)."""
    return columns(A, p[:, None])[:, :, 0].contiguous()


def _costs(c: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """c[i, idx[i]] for (B, n) c, c[idx[i]] for a shared (n,) c; idx (B,)
    or (B, m)."""
    if c.dim() == 1:
        return c.index_select(0, idx.reshape(-1).long()).view(idx.shape)
    return c.gather(1, idx.long().view(idx.shape[0], -1)).view(idx.shape)


def bounded_rhs(prob: Problem, at_upper: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """b - A x_N per instance (b when the problem has no upper bounds)."""
    b = prob.b.to(dtype)
    if prob.u is None:
        return b
    x_N = torch.where(at_upper, prob.u, 0).to(dtype)
    return b - matvec(prob.A, x_N)


def _defer_extras(Bn, m, dtype, device, L) -> dict:
    if L <= 0:
        return {}
    return {
        "U": torch.zeros((Bn, L, m), dtype=dtype, device=device),
        "R": torch.zeros((Bn, L, m), dtype=dtype, device=device),
        "npend": torch.zeros(Bn, dtype=torch.int32, device=device),
    }


def _counters(Bn, device) -> dict:
    z = torch.zeros(Bn, dtype=torch.int32, device=device)
    return {
        "iters": z, "status": torch.full_like(z, RUNNING), "degen": z.clone(),
        "last_refac": z.clone(),
    }


def batch_state_slack(prob: Problem, dtype, update_defer: int = 0) -> SolverState:
    """Every instance at the trailing-identity slack basis (bounded: all
    nonbasic columns at 0): B_inv = I, x_b = b, y = c_b = c[n-m:]."""
    Bn = prob.b.shape[0]
    m, n = _dims(prob)
    dev = prob.b.device
    c = prob.c if prob.c.dim() == 2 else prob.c.expand(Bn, n)
    c_b = c[:, n - m :].to(dtype).contiguous()
    at_upper = None
    if prob.u is not None:
        at_upper = torch.zeros((Bn, n), dtype=torch.bool, device=dev)
    return SolverState(
        B_inv=torch.eye(m, dtype=dtype, device=dev).repeat(Bn, 1, 1),
        x_b=bounded_rhs(prob, at_upper, dtype).contiguous(),
        y=c_b.clone(),
        c_b=c_b,
        basis=torch.arange(n - m, n, dtype=torch.int32, device=dev).repeat(Bn, 1),
        **_counters(Bn, dev),
        **_defer_extras(Bn, m, dtype, dev, update_defer),
        at_upper=at_upper,
    )


def batch_state_from_basis(
    prob: Problem, basis0, dtype, at_upper0=None, update_defer: int = 0
) -> SolverState:
    """Every instance at one basis (the warm re-solve's shared entry basis,
    A and c shared): one dense solve for B_inv, then x_b = B_inv (b_i -
    A x_N) per instance and y = c_b B_inv."""
    Bn = prob.b.shape[0]
    m, n = _dims(prob)
    dev = prob.b.device
    basis = torch.as_tensor(np.asarray(basis0), dtype=torch.int32, device=dev)
    Bm = columns(prob.A, basis[None])[0].to(dtype)
    B_inv = torch.linalg.solve(Bm, torch.eye(m, dtype=dtype, device=dev)).contiguous()
    c_b = _costs(prob.c, basis[None].expand(Bn, m) if prob.c.dim() == 2 else basis[None]).to(dtype)
    c_b = c_b.expand(Bn, m).contiguous()
    at_upper = None
    if prob.u is not None:
        au = np.zeros(n, bool) if at_upper0 is None else np.asarray(at_upper0, bool)
        at_upper = torch.as_tensor(au, device=dev).repeat(Bn, 1)
    B_inv_b = B_inv.repeat(Bn, 1, 1)
    return SolverState(
        B_inv=B_inv_b,
        x_b=bounded_rhs(prob, at_upper, dtype) @ B_inv.T,
        y=torch.bmm(c_b[:, None, :], B_inv_b)[:, 0],
        c_b=c_b,
        basis=basis.repeat(Bn, 1),
        **_counters(Bn, dev),
        **_defer_extras(Bn, m, dtype, dev, update_defer),
        at_upper=at_upper,
    )


def batch_state_from_numpy(leaves: Mapping[str, object], device) -> SolverState:
    """The batched state from host arrays with a leading batch axis, such as
    the stacked leaves of a vmapped ``simplex_tpu`` solver state
    (``{f: np.asarray(getattr(s, f))}``), so that both packages can take one
    batch step from identical inputs. Leaves as in
    :func:`~simplex_tpu_torch.core.state.state_from_numpy`: B_inv, x_b, y,
    c_b, basis, iters, status, degen, last_refac; optional U, R, npend
    (pass them only under deferred updates: JAX carries (B, 1, 1) dummies
    otherwise) and at_upper."""

    def put(v, dtype=None):
        t = torch.as_tensor(np.array(v), device=device)
        return t.contiguous() if dtype is None else t.to(dtype).contiguous()

    st = {f: put(leaves[f]) for f in ("B_inv", "x_b", "y", "c_b")}
    st["basis"] = put(leaves["basis"], torch.int32)
    for f in ("iters", "status", "degen", "last_refac"):
        st[f] = put(leaves[f], torch.int32).reshape(-1)
    if leaves.get("U") is not None:
        st.update(U=put(leaves["U"]), R=put(leaves["R"]), npend=put(leaves["npend"], torch.int32).reshape(-1))
    if leaves.get("at_upper") is not None:
        st["at_upper"] = put(leaves["at_upper"], torch.bool)
    return SolverState(**st)


# --------------------------------------------------------------------------
# one batch step
# --------------------------------------------------------------------------


class BatchControl(NamedTuple):
    """The host's copy of what the next batch step and the loop branch on,
    from one read, and the active mask on the device."""

    running: int  # active instances
    max_npend: int  # the largest pending-pair count (deferred updates)
    due_xy: bool  # some instance is due a recompute of x_b, y
    due_refactor: bool  # some instance is due a re-inversion
    active: torch.Tensor  # (B,) bool


def active_mask(s: SolverState, max_iter: int, members=None) -> torch.Tensor:
    act = (s.status == RUNNING) & (s.iters < max_iter)
    return act if members is None else act & members


def _use_bland(opts: SimplexOptions, degen: torch.Tensor) -> torch.Tensor:
    if opts.bland_after > 0:
        return degen >= opts.bland_after
    return torch.zeros_like(degen, dtype=torch.bool)


def _price(prob, s, opts, backend, use_bland, active):
    """Per-instance Dantzig pricing ``(p, min_e)`` (signed under bounds),
    over A or its bf16 shadow with the exact recheck and fallback. A dense
    A (per instance or shared) goes through the backend's pricing (the
    batched kernel on the hopper backend); a sparse one through one SpMM
    and the masked choice."""
    eps = opts.resolve_eps()
    at_upper = s.at_upper

    def pick(A):
        if isinstance(A, _sp.SparseA):
            e = rmat(A, s.y.to(prob.c.dtype)) - prob.c
            return _ops.choose_from_costs_batched(e, eps, use_bland, s.basis, at_upper)
        return backend.choose_entering_batched(s.y, A, prob.c, eps, use_bland, s.basis, at_upper)

    if prob.A_price is None:
        return pick(prob.A)
    p1, _ = pick(prob.A_price)
    A_p1 = entering_columns(prob.A, p1).to(s.y.dtype)
    e_p1 = torch.bmm(s.y[:, None, :], A_p1[:, :, None])[:, 0, 0] - _costs(prob.c, p1).to(s.y.dtype)
    s_p1 = e_p1 if at_upper is None else torch.where(at_upper.gather(1, p1.long()[:, None])[:, 0], -e_p1, e_p1)
    # Bland's rule takes the exact pass at once, as in the single step; a
    # finished instance's pick is not used, so it never asks for the pass
    fail = ((s_p1 >= -eps) | use_bland) & active
    if not _read([fail.any()], "branch")[0]:
        return p1, s_p1
    p2, min2 = pick(prob.A)
    return torch.where(fail, p2, p1), torch.where(fail, min2, s_p1)


def _flush(s: SolverState) -> SolverState:
    """B_inv += U^T R for every instance (zero pairs add nothing), then the
    pending buffers empty."""
    s.B_inv.baddbmm_(s.U.transpose(1, 2), s.R)
    return dataclasses.replace(
        s, U=torch.zeros_like(s.U), R=torch.zeros_like(s.R), npend=torch.zeros_like(s.npend)
    )


def _true_row(s: SolverState, q: torch.Tensor) -> torch.Tensor:
    """Row q[i] of the true inverse of each instance (a copy)."""
    Bn, m = s.x_b.shape
    q2 = q.long()[:, None]
    row = s.B_inv.gather(1, q2[:, :, None].expand(Bn, 1, m))[:, 0]
    if s.U is not None:
        uq = s.U.gather(2, q2[:, None, :].expand(Bn, s.U.shape[1], 1))
        row = row + torch.bmm(uq.transpose(1, 2), s.R)[:, 0]
    return row


def _bounded_tail(prob, s, opts, backend, active, use_bland, p, min_e, A_p, c_p, e_p, alpha):
    """The bounded rule's tail (``core.step.pivot_step`` after the ftran,
    bounded branch) for every instance; plain ops on both backends."""
    dtype = s.x_b.dtype
    Bn, m = s.x_b.shape
    eps = opts.resolve_eps()
    optimal = min_e >= -eps
    p2 = p.long()[:, None]
    from_upper = s.at_upper.gather(1, p2)[:, 0]
    d = torch.where(from_upper[:, None], -alpha, alpha)
    u_p = prob.u.index_select(0, p.long()).to(dtype)
    u_basic = prob.u.index_select(0, s.basis.reshape(-1).long()).view(Bn, m).to(dtype)
    q, theta_q, unbounded, flip, leave_upper = _ops.ratio_argmin_bounded_batched(
        s.x_b, d, u_basic, u_p, s.basis, opts.pivot_tol, use_bland,
        opts.ratio == "harris", opts.feas_tol,
    )
    take = ~optimal & ~unbounded
    bad = ~torch.isfinite(min_e) | (take & ~torch.isfinite(theta_q))
    take = take & ~bad & active
    do_pivot = take & ~flip
    q2 = q.long()[:, None]
    alpha_q = alpha.gather(1, q2)[:, 0]
    inv_aq = 1 / torch.where(do_pivot, alpha_q, 1)
    theta_safe = torch.where(take, theta_q, 0)
    is_q = torch.arange(m, device=q.device)[None, :] == q2
    eta = torch.where(is_q, (inv_aq - 1)[:, None], -alpha * inv_aq[:, None])
    x_b_step = s.x_b - theta_safe[:, None] * d
    x_p = torch.where(from_upper, u_p - theta_safe, theta_safe)
    x_b_new = torch.where(is_q, x_p[:, None], x_b_step)
    row = _true_row(s, q)
    eta = torch.where(do_pivot[:, None], eta, 0)
    row_out = torch.where(do_pivot[:, None], row, 0)
    U, R, npend = s.U, s.R, s.npend
    B_inv = s.B_inv
    if U is not None:
        slot = npend.long()[:, None, None].expand(Bn, 1, m)
        U.scatter_(1, slot, torch.where(do_pivot[:, None], eta, U.gather(1, slot)[:, 0])[:, None])
        R.scatter_(1, slot, torch.where(do_pivot[:, None], row_out, R.gather(1, slot)[:, 0])[:, None])
        npend = npend + do_pivot.to(torch.int32)
    else:
        B_inv = backend.rank1_update_batched(B_inv, eta, row_out, do_pivot)
    y_new = s.y - (e_p * inv_aq)[:, None] * row
    at_q = is_q & do_pivot[:, None]
    do_flip = take & flip
    x_b_out = torch.where(
        do_pivot[:, None], x_b_new, torch.where(do_flip[:, None], x_b_step, s.x_b)
    )
    n = s.at_upper.shape[1]
    cols = torch.arange(n, device=q.device)[None, :]
    lv = s.basis.gather(1, q2)
    at_upper = torch.where(
        (cols == p2) & take[:, None],
        (do_flip & ~from_upper)[:, None],
        torch.where((cols == lv) & do_pivot[:, None], leave_upper[:, None], s.at_upper),
    )
    degen_new = torch.where(theta_safe <= opts.degen_tol, s.degen + 1, torch.zeros_like(s.degen))
    status = torch.where(
        optimal,
        int(SolveStatus.OPTIMAL),
        torch.where(
            unbounded,
            int(SolveStatus.UNBOUNDED),
            torch.where(bad, int(SolveStatus.SINGULAR), RUNNING),
        ),
    ).to(torch.int32)
    return dataclasses.replace(
        s,
        B_inv=B_inv,
        x_b=x_b_out,
        y=torch.where(do_pivot[:, None], y_new, s.y),
        c_b=torch.where(at_q, c_p[:, None], s.c_b),
        basis=torch.where(at_q, p[:, None], s.basis),
        iters=s.iters + take.to(torch.int32),
        status=torch.where(active, status, s.status),
        degen=torch.where(take, degen_new, s.degen),
        U=U, R=R, npend=npend,
        at_upper=at_upper,
    )


def batch_pivot_step(
    prob: Problem, s: SolverState, opts: SimplexOptions, backend, ctl: BatchControl
) -> SolverState:
    """One pivot of every active instance (or its terminal status); the
    others are left as they are. ``ctl`` is this state's control read.
    Updates B_inv (and U, R) in place and returns the new state."""
    steps["primal"] += 1
    dtype = s.B_inv.dtype
    active = ctl.active
    use_bland = _use_bland(opts, s.degen)
    defer = s.U is not None
    p, min_e = _price(prob, s, opts, backend, use_bland, active)
    A_p = entering_columns(prob.A, p).to(dtype)
    c_p = _costs(prob.c, p).to(dtype)
    e_p = torch.bmm(s.y[:, None, :], A_p[:, :, None])[:, 0, 0] - c_p
    alpha = torch.bmm(s.B_inv, A_p[:, :, None])[:, :, 0]
    if defer:
        alpha = alpha + torch.bmm(s.U.transpose(1, 2), torch.bmm(s.R, A_p[:, :, None]))[:, :, 0]
    if prob.u is not None:
        s = _bounded_tail(prob, s, opts, backend, active, use_bland, p, min_e, A_p, c_p, e_p, alpha)
    else:
        extra = dict(U=s.U, R=s.R, npend=s.npend) if defer else {}
        t = backend.pivot_tail_batched(
            s.x_b, alpha, s.basis, s.y, s.c_b, s.B_inv, min_e, e_p, c_p, p,
            s.iters, s.degen, s.status, active,
            eps=opts.resolve_eps(), pivot_tol=opts.pivot_tol, feas_tol=opts.feas_tol,
            harris=opts.ratio == "harris", degen_tol=opts.degen_tol,
            bland_after=opts.bland_after, **extra,
        )
        B_inv = s.B_inv
        if not defer:
            B_inv = backend.rank1_update_batched(B_inv, t.eta, t.row, t.take)
        s = dataclasses.replace(
            s, B_inv=B_inv, x_b=t.x_b, y=t.y, c_b=t.c_b, basis=t.basis, iters=t.iters,
            status=t.status, degen=t.degen, npend=t.npend if defer else None,
        )
    if defer and ctl.max_npend + 1 >= s.U.shape[1]:
        s = _flush(s)
    return s


# --------------------------------------------------------------------------
# maintenance: recompute, re-inversion
# --------------------------------------------------------------------------


def recompute_xy(prob: Problem, s: SolverState, mask: torch.Tensor) -> SolverState:
    """x_b and y re-derived from the current inverse (pending pairs
    included) for the instances in ``mask``."""
    dtype = s.B_inv.dtype
    b = bounded_rhs(prob, s.at_upper, dtype)
    x_b = torch.bmm(s.B_inv, b[:, :, None])[:, :, 0]
    y = torch.bmm(s.c_b[:, None, :], s.B_inv)[:, 0]
    if s.U is not None:
        x_b = x_b + torch.bmm(s.U.transpose(1, 2), torch.bmm(s.R, b[:, :, None]))[:, :, 0]
        y = y + torch.bmm(torch.bmm(s.c_b[:, None, :], s.U.transpose(1, 2)), s.R)[:, 0]
    mk = mask[:, None]
    return dataclasses.replace(s, x_b=torch.where(mk, x_b, s.x_b), y=torch.where(mk, y, s.y))


def refactorize(prob: Problem, s: SolverState, mask: torch.Tensor) -> SolverState:
    """Re-invert the basis of the instances in ``mask`` (one host read for
    their indices): batched Newton-Schulz seeded with each drifted inverse
    (pending pairs folded in), then x_b, y from it, the pending pairs
    dropped and last_refac = iters; the others are left as they are."""
    idx = mask.nonzero()[:, 0]
    host_reads["maintenance"] += 1
    if idx.numel() == 0:
        return s
    dtype = s.B_inv.dtype
    sub = {f: getattr(s, f).index_select(0, idx) for f in ("B_inv", "basis", "c_b")}
    Bm = columns(instances(prob.A, idx), sub["basis"]).to(dtype)
    seed = sub["B_inv"]
    if s.U is not None:
        seed = torch.baddbmm(seed, s.U.index_select(0, idx).transpose(1, 2), s.R.index_select(0, idx))
    X, _ = inverse_newton_batched(Bm, seed)
    host_reads["maintenance"] += 1
    b = bounded_rhs(prob, s.at_upper, dtype).index_select(0, idx)
    B_inv = s.B_inv.index_copy(0, idx, X)
    new = dataclasses.replace(
        s,
        B_inv=B_inv,
        x_b=s.x_b.index_copy(0, idx, torch.bmm(X, b[:, :, None])[:, :, 0]),
        y=s.y.index_copy(0, idx, torch.bmm(sub["c_b"][:, None, :], X)[:, 0]),
        last_refac=torch.where(mask, s.iters, s.last_refac),
    )
    if s.U is not None:
        new.U = s.U.index_fill(0, idx, 0.0)
        new.R = s.R.index_fill(0, idx, 0.0)
        new.npend = torch.where(mask, 0, s.npend).to(torch.int32)
    return new


# --------------------------------------------------------------------------
# the solve loop
# --------------------------------------------------------------------------


def _due(opts: SimplexOptions, s: SolverState, was_active: torch.Tensor):
    """Per-instance maintenance masks after a step (``simplex_tpu.core.
    solver.solve_state``'s body): only instances that stepped, still
    RUNNING, with iters > 0 on the period."""
    base = was_active & (s.status == RUNNING) & (s.iters > 0)
    xy = base & (s.iters % opts.recompute_every == 0) if opts.recompute_every > 0 else None
    ref = base & (s.iters % opts.refactor_every == 0) if opts.refactor_every > 0 else None
    return xy, ref


def batch_control(s, opts, max_iter, members=None, due=(None, None)) -> BatchControl:
    """The loop's one read: active instances, the largest npend and whether
    any instance is due maintenance."""
    active = active_mask(s, max_iter, members)
    xy, ref = due
    none = torch.zeros((), dtype=torch.int32, device=active.device)
    fields = [
        active.sum(),
        none if s.npend is None else s.npend.max(),
        none if xy is None else xy.any(),
        none if ref is None else ref.any(),
    ]
    vals = _read(fields)
    return BatchControl(vals[0], vals[1], bool(vals[2]), bool(vals[3]), active)


def _loop(prob, s, opts, max_iter, backend, members=None):
    ctl = batch_control(s, opts, max_iter, members)
    while ctl.running:
        s = batch_pivot_step(prob, s, opts, backend, ctl)
        xy, ref = _due(opts, s, ctl.active)
        ctl = batch_control(s, opts, max_iter, members, (xy, ref))
        if ctl.due_xy:
            s = recompute_xy(prob, s, xy)
        if ctl.due_refactor:
            s = refactorize(prob, s, ref)
    return s


def batch_solve_state(
    prob: Problem,
    s: SolverState,
    opts: SimplexOptions,
    max_iter: int,
    backend,
    members: Optional[torch.Tensor] = None,
) -> SolverState:
    """Run the batched loop until no instance is active, then the verify
    rounds per instance; a still-running status becomes MAX_ITER.
    ``members`` (B,) bool restricts the solve to those instances (the warm
    re-solve's primal clean-up runs on the scenarios its dual loop left
    OPTIMAL); the others are not touched."""
    s = _loop(prob, s, opts, max_iter, backend, members)
    mem = torch.ones_like(s.status, dtype=torch.bool) if members is None else members
    if opts.verify_terminal:
        rounds = torch.zeros_like(s.status)
        while True:
            need = (
                mem & (s.status != RUNNING) & (s.iters < max_iter)
                & (s.iters > s.last_refac) & (rounds < MAX_VERIFY_ROUNDS)
            )
            if not _read([need.any()], "maintenance")[0]:
                break
            s = refactorize(prob, s, need)
            s.status = torch.where(need, RUNNING, s.status).to(torch.int32)
            rounds = rounds + need.to(torch.int32)
            s = _loop(prob, s, opts, max_iter, backend, members)
    still = mem & (s.status == RUNNING)
    s.status = torch.where(still, int(SolveStatus.MAX_ITER), s.status).to(torch.int32)
    return s


def objective(prob: Problem, s: SolverState, dtype) -> torch.Tensor:
    """z per instance in the solve's dtype: c_b . x_b, plus c . x_N under
    bounds."""
    z = (s.c_b * s.x_b).sum(1)
    if prob.u is not None:
        x_N = torch.where(s.at_upper, prob.u, 0).to(dtype)
        c = prob.c.to(dtype)
        z = z + (x_N * c).sum(1) if c.dim() == 2 else z + x_N @ c
    return z


def _check_options(opts: SimplexOptions, what: str) -> None:
    """The options a batched path does not run: named, never ignored."""
    if opts.pricing != "dantzig":
        raise NotImplementedError(
            f"{what}: pricing={opts.pricing!r} is not ported to the batched path "
            "yet (ROADMAP item 16b); the single solve runs it"
        )
    if opts.partial_pricing > 1:
        raise NotImplementedError(
            f"{what}: partial_pricing={opts.partial_pricing} is not ported to the "
            "batched path yet (ROADMAP item 16b)"
        )
    if opts.pricing_sparse:
        raise NotImplementedError(f"{what}: pricing_sparse is not ported to the batched path (ROADMAP item 16b)")
