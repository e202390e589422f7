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
            hopper backend, for a per-instance A, in the working dtype
            (fp32 or fp64) or its bf16 shadow,
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

The other pricing rules, as the JAX batch runs them (``vmap`` over the same
``pivot_step``), but with each instance on its own branch and a batch
paying for an extra pass only when some active instance needs it:

  devex /   the state carries e = y.A - c and the weights gamma, (B, n)
  steepest  each. The pick argmax e^2 / gamma over e < -eps (signed under
            bounds) is rechecked exactly and is *stale* when the
            incremental minimum or the rechecked e_p does not improve, the
            pick is basic, or Bland's rule is on; the stale mask is
            computed before the batch's control read and rides in it, and
            one exact ``choose_entering_batched`` pass prices the batch
            when any active instance is stale (its instances take that
            pick). After the tail: w = rho.A (rho = row q of the true
            inverse over alpha_q) as one batched product, e -= e_p w, and
            devex's max rule or steepest edge's Goldfarb-Reid recurrence
            (u = alpha.B_inv against the pre-pivot inverse; w and v one
            stacked product), on pivoting instances only
  segments  ``partial_pricing = S``: instance i prices columns [s_i w,
            (s_i + 1) w), s_i = iters_i mod S, of the shadow or of A, in
            one windowed launch of the pricing kernel that reads the
            iteration counts on the device; a winner that fails its exact
            recheck falls back to the full shadow (``fallback_shadow``),
            then to the exact pass, each stage one counted branch read

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
from simplex_tpu_torch.core.state import Problem, SolverState, steepest_gamma
from simplex_tpu_torch.core.step import _use_bland
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.status import SolveStatus

MAX_VERIFY_ROUNDS = 4
RUNNING = int(SolveStatus.RUNNING)

# device-to-host reads since the last reset: "control" (one a batch step),
# "branch" (a shadow or segment winner's failed recheck: one a fallback
# stage), "maintenance" (the refactor and verify rounds': two a
# re-inversion, its Newton loop's per-iteration reads not counted; under
# devex / steepest edge one more after a step's maintenance, for the
# re-made pick)
host_reads = {"control": 0, "branch": 0, "maintenance": 0}
# batch steps taken since the last reset, by loop
steps = {"primal": 0, "dual": 0}
# batch steps that ran an extra pricing pass, by cause: "stale" (devex /
# steepest: an exact pass, decided by the control read), "segment" (a dry
# or rejected segment winner: the full shadow or exact pass), "shadow" (a
# rejected full-shadow winner: the exact pass)
branches = {"stale": 0, "segment": 0, "shadow": 0}


def reset_host_reads() -> None:
    """Zero the read, the step and the branch counters."""
    for d in (host_reads, steps, branches):
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


def rmat2(A, Y: torch.Tensor, Z: torch.Tensor):
    """``(Y . A, Z . A)`` for (B, m) Y and Z as ONE product, so that A is
    read once: (B, 2, m) x (B, m, n) for a per-instance A, the stacked (2B,
    m) rows against a shared one."""
    if not isinstance(A, _sp.SparseA) and A.dim() == 3:
        wv = torch.bmm(torch.stack([Y, Z], 1), A.to(Y.dtype))
        return wv[:, 0], wv[:, 1]
    wv = rmat(A, torch.cat([Y, Z]))
    return wv[: Y.shape[0]], wv[Y.shape[0] :]


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


def _entering(prob: Problem, s: SolverState, p: torch.Tensor):
    """``(A_p, c_p, e_p)`` for every instance: column p[i], its cost and
    its exact reduced cost y[i].A_p - c_p (O(m) an instance)."""
    dtype = s.B_inv.dtype
    A_p = entering_columns(prob.A, p).to(dtype)
    c_p = _costs(prob.c, p).to(dtype)
    return A_p, c_p, torch.bmm(s.y[:, None, :], A_p[:, :, None])[:, 0, 0] - c_p


def _signed(s: SolverState, e_p: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """The bounded rule's criterion of column p[i]: -e_p where it sits at its
    upper bound; e_p itself without bounds."""
    if s.at_upper is None:
        return e_p
    return torch.where(s.at_upper.gather(1, p.long()[:, None])[:, 0], -e_p, e_p)


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


def _pricing_extras(prob: Problem, y: torch.Tensor, dtype, pricing: str, B_inv=None) -> dict:
    """(e, gamma), each (B, n), for the devex / steepest-edge rules
    (``simplex_tpu.core.state._pricing_extras`` with a leading axis): e =
    y[i].A - c[i] as one product (one (B, m) x (m, n) GEMM on a shared A);
    devex starts from unit weights, steepest edge from the true norms 1 +
    |B_inv A_j|^2: the column norms of A at the slack basis (``B_inv``
    None), else one (m, m) x (m, n) product with the inverse every instance
    shares (the warm re-solve's entry basis). Empty under Dantzig."""
    if pricing not in ("devex", "steepest"):
        return {}
    Bn = y.shape[0]
    n = prob.A.shape[-1]
    e = (rmat(prob.A, y) - prob.c.to(dtype)).contiguous()
    if pricing == "devex":
        gamma = torch.ones((Bn, n), dtype=dtype, device=y.device)
    elif isinstance(prob.A, torch.Tensor) and prob.A.dim() == 3:
        A = prob.A.to(dtype)  # per instance, at the slack basis
        gamma = 1 + (A * A).sum(1)
    else:
        gamma = steepest_gamma(prob, B_inv, dtype).expand(Bn, n).contiguous()
    return {"e": e, "gamma": gamma}


def steepest_gamma_batched(A, X: torch.Tensor, dtype, budget: int = 1 << 28) -> torch.Tensor:
    """gamma[i]_j = 1 + |X[i] A_j|^2 for k inverses X (k, m, m): A shared
    (dense (m, n), or a SparseA gathered 512 columns at a time) or per
    instance (k, m, n). T = X A is never whole: at most ``budget`` of its
    elements at a time (instances in chunks; the warm re-solve's 256
    scenarios at 2048 x 4096 would need 8 GiB)."""
    k, m, _ = X.shape
    n = A.shape[-1]
    sparse = isinstance(A, _sp.SparseA)
    step_n = 512 if sparse else n
    step_k = max(1, budget // (m * step_n))
    out = torch.empty((k, n), dtype=dtype, device=X.device)
    for j0 in range(0, n, step_n):
        j1 = min(j0 + step_n, n)
        if sparse:
            cols = _sp.gather_columns(A, torch.arange(j0, j1, device=X.device)).to(dtype)
        elif A.dim() == 2:
            cols = A[:, j0:j1].to(dtype)
        for i0 in range(0, k, step_k):
            i1 = min(i0 + step_k, k)
            rhs = A[i0:i1, :, j0:j1].to(dtype) if not sparse and A.dim() == 3 else cols
            T = torch.matmul(X[i0:i1], rhs)
            out[i0:i1, j0:j1] = 1 + (T * T).sum(1)
    return out


def batch_state_slack(
    prob: Problem, dtype, update_defer: int = 0, pricing: str = "dantzig"
) -> SolverState:
    """Every instance at the trailing-identity slack basis (bounded: all
    nonbasic columns at 0): B_inv = I, x_b = b, y = c_b = c[n-m:]; under
    devex / steepest edge also e and gamma."""
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
        **_pricing_extras(prob, c_b, dtype, pricing),
    )


def batch_state_from_basis(
    prob: Problem, basis0, dtype, at_upper0=None, update_defer: int = 0,
    pricing: str = "dantzig",
) -> SolverState:
    """Every instance at one basis (the warm re-solve's shared entry basis,
    A and c shared): one dense solve for B_inv, then x_b = B_inv (b_i -
    A x_N) per instance and y = c_b B_inv; under devex / steepest edge e
    and gamma from that basis (the dual loop carries them untouched, and
    the phase switch re-derives them)."""
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
    y = torch.bmm(c_b[:, None, :], B_inv_b)[:, 0]
    return SolverState(
        B_inv=B_inv_b,
        x_b=bounded_rhs(prob, at_upper, dtype) @ B_inv.T,
        y=y,
        c_b=c_b,
        basis=basis.repeat(Bn, 1),
        **_counters(Bn, dev),
        **_defer_extras(Bn, m, dtype, dev, update_defer),
        at_upper=at_upper,
        **_pricing_extras(prob, y, dtype, pricing, B_inv),
    )


def batch_state_from_numpy(leaves: Mapping[str, object], device) -> SolverState:
    """The batched state from host arrays with a leading batch axis, such as
    the stacked leaves of a vmapped ``simplex_tpu`` solver state
    (``{f: np.asarray(getattr(s, f))}``), so that both packages can take one
    batch step from identical inputs. Leaves as in
    :func:`~simplex_tpu_torch.core.state.state_from_numpy`: B_inv, x_b, y,
    c_b, basis, iters, status, degen, last_refac; optional U, R, npend
    (pass them only under deferred updates: JAX carries (B, 1, 1) dummies
    otherwise), at_upper, and e and gamma (devex / steepest edge only: JAX
    carries (B, 1) dummies otherwise)."""

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
    if leaves.get("e") is not None:
        st.update(e=put(leaves["e"]), gamma=put(leaves["gamma"]))
    return SolverState(**st)


# --------------------------------------------------------------------------
# one batch step
# --------------------------------------------------------------------------


class WeightedPick(NamedTuple):
    """The devex / steepest-edge pick of every instance, with its exact
    recheck (on the device)."""

    p: torch.Tensor  # (B,) int32
    min_e: torch.Tensor  # (B,) the incremental minimum (bounded: the pick's exact signed e)
    A_p: torch.Tensor  # (B, m)
    c_p: torch.Tensor  # (B,)
    e_p: torch.Tensor  # (B,) exact
    stale: torch.Tensor  # (B,) bool: this instance takes the exact pass


class BatchControl(NamedTuple):
    """The host's copy of what the next batch step and the loop branch on,
    from one read, and the active mask on the device."""

    running: int  # active instances
    max_npend: int  # the largest pending-pair count (deferred updates)
    due_xy: bool  # some instance is due a recompute of x_b, y
    due_refactor: bool  # some instance is due a re-inversion
    active: torch.Tensor  # (B,) bool
    # devex / steepest edge: the next step's pick, and whether any active
    # instance's pick is stale (then the step runs one exact pass)
    pick: Optional[WeightedPick] = None
    stale: bool = False


def active_mask(s: SolverState, max_iter: int, members=None) -> torch.Tensor:
    act = (s.status == RUNNING) & (s.iters < max_iter)
    return act if members is None else act & members


def weighted_active(opts: SimplexOptions, s: SolverState) -> bool:
    return opts.pricing in ("devex", "steepest") and s.e is not None


def segments(opts: SimplexOptions, prob: Problem):
    """``(w, S)`` when segmented pricing is on (``simplex_tpu.core.step.
    _partial_active``'s static test: S | n and w = n / S at least
    ``partial_min_segment``, on a dense A), else None."""
    if isinstance(prob.A, _sp.SparseA):
        return None
    S, n = opts.partial_pricing, prob.A.shape[-1]
    if S > 1 and n % S == 0 and n // S >= opts.partial_min_segment:
        return n // S, S
    return None


def weighted_pick(prob: Problem, s: SolverState, opts: SimplexOptions) -> WeightedPick:
    """The devex / steepest-edge pick of every instance from the maintained
    e and gamma (``simplex_tpu.core.step.pivot_step``'s devex branches under
    vmap), rechecked exactly: stale where the incremental minimum or the
    rechecked e_p does not improve (signed under bounds), where the pick is
    basic, or where Bland's rule is on."""
    eps = opts.resolve_eps()
    no_bland = torch.zeros_like(s.status, dtype=torch.bool)
    if s.at_upper is not None:
        p1, min1 = _ops.devex_choose_bounded_batched(s.e, s.gamma, s.at_upper, eps, no_bland)
    else:
        p1, min1 = _ops.devex_choose_batched(s.e, s.gamma, eps, no_bland)
    A_p, c_p, e_p = _entering(prob, s, p1)
    s_p1 = _signed(s, e_p, p1)
    basic = (s.basis == p1[:, None]).any(1)
    stale = (min1 >= -eps) | (s_p1 >= -eps) | basic | _use_bland(opts, s.degen)
    return WeightedPick(p1, min1 if s.at_upper is None else s_p1, A_p, c_p, e_p, stale)


def _price(prob, s, opts, backend, use_bland, active, ctl):
    """Per-instance pricing ``(p, min_e, col)`` (signed under bounds):
    ``col`` is ``_entering``'s (A_p, c_p, e_p) where the pick's recheck
    computed it, else None. Devex / steepest edge take the control read's
    pick (one exact pass when it said some active instance is stale);
    Dantzig prices a segment, the bf16 shadow or A, each winner rechecked
    exactly, with the fallbacks of the single step, each stage taken only
    when some active instance needs it. A dense A (per instance or shared)
    goes through the backend's pricing (the batched kernel on the hopper
    backend, windowed for a segment); a sparse one through one SpMM and the
    masked choice."""
    eps = opts.resolve_eps()
    at_upper = s.at_upper

    def pick(A, flag=use_bland, window=None):
        if isinstance(A, _sp.SparseA):
            e = rmat(A, s.y.to(prob.c.dtype)) - prob.c
            return _ops.choose_from_costs_batched(e, eps, flag, s.basis, at_upper)
        return backend.choose_entering_batched(s.y, A, prob.c, eps, flag, s.basis, at_upper, window)

    def recheck(p):
        col = _entering(prob, s, p)
        return col, _signed(s, col[2], p)

    if weighted_active(opts, s):
        pk = ctl.pick
        if pk is None:
            raise ValueError(
                "devex / steepest edge: the control read carries no pick "
                "(batch_control needs prob under these rules)"
            )
        if not ctl.stale:
            return pk.p, pk.min_e, (pk.A_p, pk.c_p, pk.e_p)
        branches["stale"] += 1
        p2, min2 = pick(prob.A)
        return torch.where(pk.stale, p2, pk.p), torch.where(pk.stale, min2, pk.min_e), None

    seg = segments(opts, prob)
    if seg is None and prob.A_price is None:
        return (*pick(prob.A), None)
    no_bland = torch.zeros_like(use_bland)
    if seg is not None:
        # the segment (iters mod S) of the shadow, or of A; Bland's rule is
        # off inside it (its instances fail the recheck below)
        A_src = prob.A_price if prob.A_price is not None else prob.A
        p1, _ = pick(A_src, no_bland, (seg[0], seg[1], s.iters))
    else:
        p1, _ = pick(prob.A_price)
    col, s_p1 = recheck(p1)
    # Bland's rule takes the exact pass at once, as in the single step; a
    # finished instance's pick is not used, so it never asks for the pass
    fail = ((s_p1 >= -eps) | use_bland) & active
    if not _read([fail.any()], "branch")[0]:
        return p1, s_p1, col
    if seg is not None:
        branches["segment"] += 1
        if prob.A_price is not None and opts.fallback_shadow:
            p2, _ = pick(prob.A_price, no_bland)
            _, s_p2 = recheck(p2)
            p1, s_p1 = torch.where(fail, p2, p1), torch.where(fail, s_p2, s_p1)
            fail = fail & ((s_p2 >= -eps) | use_bland)
            if not _read([fail.any()], "branch")[0]:
                return p1, s_p1, None
            branches["shadow"] += 1
    else:
        branches["shadow"] += 1
    p3, min3 = pick(prob.A)
    return torch.where(fail, p3, p1), torch.where(fail, min3, s_p1), None


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
    bounded branch) for every instance; plain ops on both backends. Returns
    the new state, row q of the true pre-pivot inverse, q and do_pivot."""
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
    new = dataclasses.replace(
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
    return new, row, q, do_pivot


def _pre_pivot_u(s: SolverState, opts: SimplexOptions, alpha: torch.Tensor):
    """Steepest edge's u = alpha . B_inv per instance against the TRUE
    pre-pivot inverse (pending pairs included, O(L m)); None under the
    other rules. Taken before the step rewrites B_inv, U or R."""
    if opts.pricing != "steepest":
        return None
    a = alpha[:, None, :]
    u = torch.bmm(a, s.B_inv)
    if s.U is not None:
        u = u + torch.bmm(torch.bmm(a, s.U.transpose(1, 2)), s.R)
    return u[:, 0]


def _update_weights(prob, s, opts, p, e_p, alpha, u, row, q, do_pivot):
    """The post-pivot e and gamma of every instance (``simplex_tpu.core.
    step.pivot_step``'s incremental pricing block): ``s`` the PRE-pivot
    state, ``row`` row q of its true inverse, ``u`` from
    :func:`_pre_pivot_u`. w = rho.A (rho = row / alpha_q) is one batched
    product (w and steepest edge's v = u.A one stacked product); e -= e_p w;
    devex: gamma = max(gamma, w^2 max(gamma_p, 1)); steepest edge: gamma -=
    2 w v - w^2 (1 + |alpha|^2), the leaving column's weight set exactly;
    both clipped to [1, 1e30]. An instance that does not pivot keeps e and
    gamma bit for bit."""
    q2 = q.long()[:, None]
    alpha_q = alpha.gather(1, q2)[:, 0]
    safe_aq = torch.where(do_pivot, alpha_q, 1)
    inv_aq = 1 / safe_aq
    rho = row * inv_aq[:, None]
    if u is not None:
        w, v = rmat2(prob.A, rho, u)
    else:
        w = rmat(prob.A, rho)
    e_new = s.e - e_p[:, None] * w
    if u is not None:
        gp1 = 1 + (alpha * alpha).sum(1)
        lv = s.basis.gather(1, q2).long()
        gamma_lv = 1 + (gp1 - safe_aq * safe_aq) * (inv_aq * inv_aq)
        gse = s.gamma - 2 * w * v + (w * w) * gp1[:, None]
        # floored at the provable minimum 1, capped like devex
        gamma_new = gse.scatter(1, lv, gamma_lv[:, None]).clamp(1.0, 1e30)
    else:
        gamma_p = s.gamma.gather(1, p.long()[:, None])
        gamma_new = torch.maximum(s.gamma, (w * w) * gamma_p.clamp_min(1)).clamp(1.0, 1e30)
    keep = do_pivot[:, None]
    return torch.where(keep, e_new, s.e), torch.where(keep, gamma_new, s.gamma)


def batch_pivot_step(
    prob: Problem, s: SolverState, opts: SimplexOptions, backend, ctl: BatchControl
) -> SolverState:
    """One pivot of every active instance (or its terminal status); the
    others are left as they are. ``ctl`` is this state's control read.
    Updates B_inv (and U, R) in place and returns the new state."""
    steps["primal"] += 1
    active = ctl.active
    use_bland = _use_bland(opts, s.degen)
    defer = s.U is not None
    weighted = weighted_active(opts, s)
    p, min_e, col = _price(prob, s, opts, backend, use_bland, active, ctl)
    A_p, c_p, e_p = col if col is not None else _entering(prob, s, p)
    alpha = torch.bmm(s.B_inv, A_p[:, :, None])[:, :, 0]
    if defer:
        alpha = alpha + torch.bmm(s.U.transpose(1, 2), torch.bmm(s.R, A_p[:, :, None]))[:, :, 0]
    # steepest edge: before the update rewrites B_inv, U or R
    u_se = _pre_pivot_u(s, opts, alpha) if weighted else None
    pre = s
    if prob.u is not None:
        s, row, q, do_pivot = _bounded_tail(
            prob, s, opts, backend, active, use_bland, p, min_e, A_p, c_p, e_p, alpha
        )
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
        row, q, do_pivot = t.row, t.q, t.take
    if weighted:
        s.e, s.gamma = _update_weights(prob, pre, opts, p, e_p, alpha, u_se, row, q, do_pivot)
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


def refactorize(
    prob: Problem, s: SolverState, mask: torch.Tensor, pricing: str = "dantzig",
    exact_gamma: bool = False,
) -> SolverState:
    """Re-invert the basis of the instances in ``mask`` (one host read for
    their indices): batched Newton-Schulz seeded with each drifted inverse
    (pending pairs folded in), then x_b, y from it, the pending pairs
    dropped and last_refac = iters; the others are left as they are.

    Under devex / steepest edge (``pricing``, a state that carries e) e is
    re-derived exactly; devex resets its weights to 1, steepest edge keeps
    gamma (the true norms depend on the basis alone), or with
    ``exact_gamma`` recomputes 1 + |B_inv A_j|^2 (the warm re-solve's phase
    switch: the dual loop does not maintain the weights)."""
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
    y_sub = torch.bmm(sub["c_b"][:, None, :], X)[:, 0]
    new = dataclasses.replace(
        s,
        B_inv=B_inv,
        x_b=s.x_b.index_copy(0, idx, torch.bmm(X, b[:, :, None])[:, :, 0]),
        y=s.y.index_copy(0, idx, y_sub),
        last_refac=torch.where(mask, s.iters, s.last_refac),
    )
    if pricing in ("devex", "steepest") and s.e is not None:
        A_sub = instances(prob.A, idx)
        c_sub = prob.c if prob.c.dim() == 1 else prob.c.index_select(0, idx)
        new.e = s.e.index_copy(0, idx, rmat(A_sub, y_sub) - c_sub.to(dtype))
        if pricing == "devex":
            new.gamma = s.gamma.index_fill(0, idx, 1.0)
        elif exact_gamma:
            new.gamma = s.gamma.index_copy(0, idx, steepest_gamma_batched(A_sub, X, dtype))
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


def batch_control(s, opts, max_iter, members=None, due=(None, None), prob=None) -> BatchControl:
    """The loop's one read: active instances, the largest npend, whether
    any instance is due maintenance and, under devex / steepest edge (given
    ``prob``), the next step's pick with whether any active instance's
    pick is stale."""
    active = active_mask(s, max_iter, members)
    xy, ref = due
    none = torch.zeros((), dtype=torch.int32, device=active.device)
    pick = None
    if prob is not None and weighted_active(opts, s):
        pick = weighted_pick(prob, s, opts)
    fields = [
        active.sum(),
        none if s.npend is None else s.npend.max(),
        none if xy is None else xy.any(),
        none if ref is None else ref.any(),
        none if pick is None else (pick.stale & active).any(),
    ]
    vals = _read(fields)
    return BatchControl(vals[0], vals[1], bool(vals[2]), bool(vals[3]), active, pick, bool(vals[4]))


def _loop(prob, s, opts, max_iter, backend, members=None):
    ctl = batch_control(s, opts, max_iter, members, prob=prob)
    while ctl.running:
        s = batch_pivot_step(prob, s, opts, backend, ctl)
        xy, ref = _due(opts, s, ctl.active)
        ctl = batch_control(s, opts, max_iter, members, (xy, ref), prob)
        if ctl.due_xy:
            s = recompute_xy(prob, s, xy)
        if ctl.due_refactor:
            s = refactorize(prob, s, ref, opts.pricing)
        if ctl.pick is not None and (ctl.due_xy or ctl.due_refactor):
            # the maintenance moved y (and e): the pick is made again
            pick = weighted_pick(prob, s, opts)
            stale = _read([(pick.stale & ctl.active).any()], "maintenance")[0]
            ctl = ctl._replace(pick=pick, stale=bool(stale))
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
            s = refactorize(prob, s, need, opts.pricing)
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

