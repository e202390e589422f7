"""One revised-simplex pivot on device tensors.

The paths of ``simplex_tpu.core.step.pivot_step`` under the Dantzig rule:

  pricing      e = y.A - c with the basic columns masked; p = argmin e;
               optimal iff min e >= -eps; mask, scan and choice in one
               backend call. Either over all of A, or over the
               bfloat16 shadow (``A_price``) with an exact recheck of the
               winner, or over one column segment (``partial_pricing``) with
               the two-stage fallback (full shadow, then exact), or from the
               multiple-pricing candidate buffer (``multi_price``)
  ftran        alpha = B_inv @ A_p, plus U.T (R A_p) for pending pairs; from
               the buffered base column under multiple pricing
  ratio test   Harris (default) or classic; q, theta_q; unbounded iff no
               alpha_i > pivot_tol; eta and the stepped x_b from the same
               launch on the hopper backend
  update       eager: B_inv += eta (x) B_inv[q] (in place); deferred: append
               (eta, true row q) to U / R and flush B_inv += U.T R (one
               fp32 GEMM, in place) when L pairs are pending
               y -= (e_p / alpha_q) B_inv_old[q];  c_b[q] = c_p;  basis[q] = p

Without bounds and without multiple pricing, everything from the ratio test
to the stored leaves (the O(m) selects, the scalars, the pair appended to
U / R) is one backend call, ``pivot_tail``: one launch on the hopper
backend. The multiple-pricing and the bounded step keep the op-by-op tail
below.

Under upper bounds (``prob.u``, the bounded-variable rule) pricing takes
the signed reduced cost s_j = at_upper_j ? -e_j : e_j, the ratio test is
two-sided over d = sigma alpha (sigma = -1 when the entering column leaves
its upper bound) and plain torch (``ratio_eta`` is not used), and a step
either pivots or flips the entering column to its other bound: a flip
moves x_b and ``at_upper`` and leaves the basis, B_inv and y alone.
Whether a problem is bounded is a Python bool, so the unbounded step
launches what it launched before.

A sparse A (:class:`~simplex_tpu_torch.sparse.SparseA`) runs the same
step: pricing is one SpMV over A^T and the masked argmin (the hopper
backend's ``choose_entering`` takes the plain ops there; ``pricing_scan``
reads dense A), the entering column is a fixed-length gather with no host
read, and segmented pricing scans the prebuilt segments ``prob.A_segs``.
The ftran, the tail and the update do not read A and are unchanged.

Under ``pricing="devex"`` / ``"steepest"`` the state carries the reduced
costs e = y.A - c and the weights gamma, both maintained incrementally:

  pricing      p = argmax e_j^2 / gamma_j over e_j < -eps (signed under
               bounds), O(n); the pick is rechecked exactly (O(m)) and is
               *stale* when the incremental minimum or the rechecked e_p
               does not improve, or p is already basic; a stale pick, and
               Bland's rule, take one exact pass (``choose_entering`` /
               ``choose_entering_bounded``: the pricing kernel)
  update       on a pivot: w = rho.A with rho = row q of the true inverse
               over alpha_q (one O(mn) pass); e -= e_p w; devex: gamma =
               max(gamma, w^2 max(gamma_p, 1)); steepest (Goldfarb-Reid):
               gamma -= 2 w v - w^2 (1 + |alpha|^2) with v = u.A and
               u = alpha . B_inv_old (one more O(m^2) pass, taken before
               the inverse is rewritten; w and v share one (2, m) x (m, n)
               product), the leaving column's weight set exactly; both
               clipped to [1, 1e30]. A bound flip and a terminal step
               change neither e nor gamma.

Every decision that picks a value is a device tensor: a step that does not
pivot (a terminal status) leaves the state as it was through
``torch.where`` selects and a zeroed update. Where the JAX step picks a
whole branch with ``lax.cond``, this step decides on the host, so that the
branch not taken costs nothing:

  * from :class:`Control`, the scalars the solver reads once per pivot
    (``read_control``): the segment (``iters mod S``), whether the
    candidate buffer needs a refill, whether pending pairs must be flushed,
    whether Bland's rule is on, and, under devex / steepest edge, whether
    the next step's pick is stale (the pick itself rides along as device
    tensors, so the step does not price twice);
  * by one explicit read (:func:`read_flag`) where the branch depends on a
    value the step itself computed: whether a shadow or segment winner
    failed its exact recheck (then the fallback pass runs).

``host_reads`` counts both kinds of read. Each read, and each section of
the step (pricing, ftran, ratio test and tail, update, weights), is a host
span while spans are recorded (:mod:`simplex_tpu_torch.spans`).

The default step on dense CUDA tensors runs as one replay of a CUDA graph
of the same launches (:mod:`simplex_tpu_torch.core.graph`, which says which
steps those are), once its key has run one eager step; ``graph_steps``
counts the steps by how they ran.

Matrix products run in full fp32 (the solver turns TF32 off), the
counterpart of the JAX package's ``Precision.HIGHEST`` pins.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch import spans
from simplex_tpu_torch.config import SimplexOptions
from simplex_tpu_torch.core.linalg import inverse_newton
from simplex_tpu_torch.core.state import CandBuffer, Problem, SolverState, bounded_rhs
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.status import SolveStatus

# device-to-host reads since the last reset: "control" (one per pivot, by
# read_control) and "branch" (read_flag, inside a step)
host_reads = {"control": 0, "branch": 0}
# pivot steps since the last reset by how they ran: "eager" (launched op by
# op), "captured" (default steps recorded as a CUDA graph, simplex_tpu_torch.
# core.graph) and "replayed" (steps run as one replay of such a graph); of
# the replayed, "ahead": those enqueued before the previous step's control
# words were read
graph_steps = {"captured": 0, "replayed": 0, "eager": 0, "ahead": 0}


def reset_host_reads() -> None:
    for k in host_reads:
        host_reads[k] = 0


def reset_graph_steps() -> None:
    for k in graph_steps:
        graph_steps[k] = 0


def read_flag(t: torch.Tensor) -> bool:
    """A device bool on the host: one explicit, counted sync."""
    host_reads["branch"] += 1
    span = spans.start("read", "branch")
    flag = bool(t)
    spans.stop(span)
    return flag


class Control(NamedTuple):
    """Host copies of the device scalars the solve loop and the next pivot
    step branch on, from one read."""

    status: int
    iters: int
    degen: int
    last_refac: int
    pert_rounds: int = 0
    pert_on: bool = False
    npend: int = 0  # pending deferred pairs
    seg: int = 0  # candidate-buffer refill counter
    need_refill: bool = False  # the next step refills the candidate buffer
    stale: bool = False  # devex / steepest: the next step's pick is stale
    # devex / steepest: that pick, (p, min_e, (A_p, c_p, e_p)) on the device
    pick: Optional[tuple] = None


def _multi_active(opts: SimplexOptions, state: SolverState) -> bool:
    return opts.multi_price > 0 and opts.pricing == "dantzig" and state.cand is not None


def bland_on(opts: SimplexOptions, degen: int) -> bool:
    """Bland's rule on the host: ``degen`` degenerate pivots in a row reached
    ``bland_after`` (0: never)."""
    return opts.bland_after > 0 and degen >= opts.bland_after


def _use_bland(opts: SimplexOptions, degen: torch.Tensor) -> torch.Tensor:
    """:func:`bland_on` on the device, of ``degen``'s shape: a 0-d degen
    off the rule gets the cached constant, a batched one its own zeros."""
    if opts.bland_after > 0:
        return degen >= opts.bland_after
    if degen.dim() == 0:
        return _const_flag(degen.device, False)
    return torch.zeros_like(degen, dtype=torch.bool)


_flags: dict = {}


def _const_flag(device, value: bool) -> torch.Tensor:
    """A 0-d bool constant on ``device``, made once (never written to)."""
    key = (device, bool(value))
    if key not in _flags:
        _flags[key] = torch.tensor(bool(value), device=device)
    return _flags[key]


def _need_refill(state: SolverState, opts: SimplexOptions) -> torch.Tensor:
    """Whether the next multiple-pricing step refills its buffer
    (``simplex_tpu.core.step._multi_pricing``): no candidate still delivers
    ``multi_price_stale`` of the refill-time best improvement, Bland's rule
    is on, a degenerate streak reached ``multi_price_degen``, or the
    pending-pair buffer is full. Under bounds every criterion is signed."""
    cand = state.cand
    eps = opts.resolve_eps()
    best_now = torch.where(cand.valid, _signed(state, cand.e, cand.idx), math.inf).min()
    thresh = torch.clamp_max(cand.e0 * opts.multi_price_stale, -eps)
    need = (
        (best_now > thresh)
        | _use_bland(opts, state.degen)
        | (state.degen >= max(opts.multi_price_degen, 1))
    )
    if opts.resolve_defer() > 0:
        need = need | (state.npend >= opts.resolve_defer())
    return need


def _weighted_active(opts: SimplexOptions, state: SolverState) -> bool:
    return opts.pricing in ("devex", "steepest") and state.e is not None


def _weighted_pick(prob: Problem, state: SolverState, opts: SimplexOptions, backend):
    """The devex / steepest-edge pick from the maintained e and gamma, with
    its exact recheck (``simplex_tpu.core.step.pivot_step``'s devex
    branches, Bland's rule aside: the caller knows that on the host).
    Returns ``((p, min_e, col), stale)``: ``col`` the pick's
    ``_entering_column``, ``min_e`` the incremental minimum (under bounds
    the pick's exact signed reduced cost), ``stale`` a device bool."""
    eps = opts.resolve_eps()
    no_bland = _const_flag(state.y.device, False)
    if state.at_upper is not None:
        p1, min1 = backend.devex_choose_bounded(
            state.e, state.gamma, state.at_upper, eps, no_bland
        )
    else:
        p1, min1 = backend.devex_choose(state.e, state.gamma, eps, no_bland)
    col = _entering_column(prob, state, p1, backend)
    s_p1 = _signed(state, col[2], p1)
    # stale also when the drifted e picked an already-basic column
    stale = (min1 >= -eps) | (s_p1 >= -eps) | (state.basis == p1).any()
    return (p1, min1 if state.at_upper is None else s_p1, col), stale


def control_fields(
    state: SolverState,
    opts: Optional[SimplexOptions] = None,
    prob: Optional[Problem] = None,
    backend=None,
):
    """``(fields, pick)``: the device scalars :func:`read_control` reads,
    by :class:`Control` field, and the devex / steepest-edge pick (None
    under the other rules)."""
    fields = {
        "status": state.status,
        "iters": state.iters,
        "degen": state.degen,
        "last_refac": state.last_refac,
    }
    if state.pert is not None:
        fields.update(pert_rounds=state.pert.rounds, pert_on=state.pert.on)
    if state.npend is not None:
        fields["npend"] = state.npend
    if state.cand is not None:
        fields["seg"] = state.cand.seg
        if opts is not None and _multi_active(opts, state):
            fields["need_refill"] = _need_refill(state, opts)
    pick = None
    if opts is not None and prob is not None and _weighted_active(opts, state):
        pick, fields["stale"] = _weighted_pick(prob, state, opts, backend)
    return fields, pick


def pack_control(fields: dict) -> torch.Tensor:
    """The control words in one int32 block, in the order of ``fields``."""
    return torch.stack([v.to(torch.int32) for v in fields.values()])


def read_control(
    state: SolverState,
    opts: Optional[SimplexOptions] = None,
    prob: Optional[Problem] = None,
    backend=None,
) -> Control:
    """The loop's control scalars and the next step's branch flags in ONE
    device-to-host read. ``need_refill`` needs ``opts``; the devex /
    steepest-edge pick and its ``stale`` flag need ``prob`` and ``backend``
    too. A state that a replay of the backend's step graph returned is read
    from the words the graph copied to the host, once the event after that
    replay has completed (:mod:`simplex_tpu_torch.core.graph`): a step
    enqueued after it does not hold the read back."""
    fields, pick = control_fields(state, opts, prob, backend)
    graphs = getattr(backend, "step_graphs", None)
    block = graphs.control_block(state) if graphs is not None else None
    packed = pack_control(fields) if block is None else None
    span = spans.start("read", "control")
    if block is None:
        vals = packed.tolist()
    else:
        done, words = block
        done.synchronize()
        vals = words.tolist()
    spans.stop(span)
    host_reads["control"] += 1
    ctl = dict(zip(fields, vals))
    for k in ("pert_on", "need_refill", "stale"):
        if k in ctl:
            ctl[k] = bool(ctl[k])
    return Control(**ctl, pick=pick)


def _partial_active(opts: SimplexOptions, prob: Problem) -> bool:
    """Segmented pricing needs S | n and segments of at least
    ``partial_min_segment`` columns (tiny segments cost more than they
    save). A sparse A segments when the solve built its column segments
    (``prob.A_segs``)."""
    if isinstance(prob.A, _sp.SparseA):
        return prob.A_segs is not None
    S, n = opts.partial_pricing, prob.A.shape[1]
    return S > 1 and n % S == 0 and n // S >= opts.partial_min_segment


def _segment(prob: Problem, A_src, lo: int, w: int):
    """Columns [lo, lo + w) of the pricing source: a view of a dense A or
    shadow, or the prebuilt segment of a sparse one."""
    if prob.A_segs is not None:
        return prob.A_segs[lo // w]
    return A_src[:, lo : lo + w]


def _entering_column(prob: Problem, state: SolverState, p: torch.Tensor, backend):
    """``(A_p, c_p, e_p)``: column p of A, its cost, and its exact reduced
    cost y.A_p - c_p (O(m))."""
    dtype = state.B_inv.dtype
    A_p, c_p = backend.gather_column_cost(prob.A, prob.c, p)
    A_p, c_p = A_p.to(dtype), c_p.to(dtype)
    return A_p, c_p, torch.dot(state.y, A_p) - c_p


def _exact_e(prob: Problem, state: SolverState, p: torch.Tensor, backend) -> torch.Tensor:
    """The exact reduced cost y.A_p - c_p of column p (O(m))."""
    return _entering_column(prob, state, p, backend)[2]


def _signed(state: SolverState, e: torch.Tensor, idx: Optional[torch.Tensor] = None):
    """The bounded rule's improvement criterion: -e at the at-upper columns
    (``idx`` the columns e belongs to; all of them when None); e itself
    when the problem has no bounds."""
    if state.at_upper is None:
        return e
    up = state.at_upper if idx is None else state.at_upper.index_select(0, idx.view(-1))
    return torch.where(up.view(e.shape), -e, e)


def _price_bounded(prob, state, opts, use_bland, bland, ctl, backend):
    """Signed Dantzig pricing (``simplex_tpu.core.step.pivot_step``'s
    bounded branch): over all of A, over the bf16 shadow, or over segment
    ``iters mod S``, each winner rechecked exactly through its current
    at_upper flag, with the same fallbacks as the unbounded rule. Returns
    ``(p, min_s)``."""
    eps = opts.resolve_eps()
    no_bland = _const_flag(state.y.device, False)

    def pick(A, lo=0, w=None, flag=use_bland):
        hi = None if w is None else lo + w
        return backend.choose_entering_bounded(
            state.y, A, prob.c[lo:hi], state.at_upper[lo:hi], state.basis, lo, eps, flag
        )

    def rechecked(p):
        # the winner's exact signed reduced cost; one counted read decides
        s_p = _signed(state, _exact_e(prob, state, p, backend), p)
        return None if read_flag(s_p >= -eps) else (p, s_p)

    def exact():
        return pick(prob.A)

    if bland:
        return exact()
    if _partial_active(opts, prob):
        S, n = opts.partial_pricing, prob.A.shape[1]
        w = n // S
        lo = (ctl.iters % S) * w
        A_src = prob.A_price if prob.A_price is not None else prob.A
        got = rechecked(pick(_segment(prob, A_src, lo, w), lo, w, no_bland)[0])
        if got is None and prob.A_price is not None and opts.fallback_shadow:
            got = rechecked(pick(prob.A_price, flag=no_bland)[0])
        return got if got is not None else exact()
    if prob.A_price is not None:
        got = rechecked(pick(prob.A_price)[0])
        return got if got is not None else exact()
    return exact()


def _price_shadow(prob, state, opts, use_bland, bland, backend):
    """Dantzig over the bfloat16 shadow, the winner rechecked exactly; one
    exact pass when it does not improve or Bland's rule is on. Returns
    ``(p, min_e, col)``; ``col`` is the winner's ``_entering_column`` when
    the recheck computed it, else None."""
    eps = opts.resolve_eps()
    if not bland:
        p1, _ = backend.choose_entering(state.y, prob.A_price, prob.c, eps, use_bland, state.basis)
        col = _entering_column(prob, state, p1, backend)
        if not read_flag(col[2] >= -eps):
            return p1, col[2], col
    return (*backend.choose_entering(state.y, prob.A, prob.c, eps, use_bland, state.basis), None)


def _price_segment(prob, state, opts, use_bland, bland, ctl, backend):
    """Dantzig over column segment ``iters mod S`` (of the shadow when there
    is one), a view priced in place. A dry segment retries over the full
    shadow (``fallback_shadow``), then runs one exact pass; so does Bland's
    rule at once. Returns ``(p, min_e, col)`` as :func:`_price_shadow`."""
    eps = opts.resolve_eps()

    def exact():
        return (*backend.choose_entering(state.y, prob.A, prob.c, eps, use_bland, state.basis), None)

    if bland:
        return exact()
    S, n = opts.partial_pricing, prob.A.shape[1]
    w = n // S
    lo = (ctl.iters % S) * w
    A_src = prob.A_price if prob.A_price is not None else prob.A
    p1, _ = backend.choose_entering(
        state.y, _segment(prob, A_src, lo, w), prob.c[lo : lo + w], eps, use_bland, state.basis, lo
    )
    col = _entering_column(prob, state, p1, backend)
    if not read_flag(col[2] >= -eps):
        return p1, col[2], col
    if prob.A_price is None or not opts.fallback_shadow:
        return exact()
    p2, _ = backend.choose_entering(state.y, prob.A_price, prob.c, eps, use_bland, state.basis)
    col = _entering_column(prob, state, p2, backend)
    if not read_flag(col[2] >= -eps):
        return p2, col[2], col
    return exact()


def _price_weighted(prob, state, opts, use_bland, bland, ctl, backend):
    """Devex / steepest-edge pricing: the pick the control read carries, or
    one exact pass when that pick is stale or Bland's rule is on. Returns
    ``(p, min_e, col)`` as :func:`_price_shadow`."""
    eps = opts.resolve_eps()
    if not bland:
        if ctl.pick is None:
            raise ValueError(
                "devex / steepest edge: the control read carries no pick "
                "(read_control needs prob and backend under these rules)"
            )
        if not ctl.stale:
            return ctl.pick
    if state.at_upper is not None:
        p, min_e = backend.choose_entering_bounded(
            state.y, prob.A, prob.c, state.at_upper, state.basis, 0, eps, use_bland
        )
    else:
        p, min_e = backend.choose_entering(state.y, prob.A, prob.c, eps, use_bland, state.basis)
    return p, min_e, None


def _pre_pivot_u(state, opts, alpha, defer):
    """Steepest edge's u = alpha . B_inv against the TRUE pre-pivot inverse
    (the base plus the pending pairs, O(L m)); None under the other rules.
    Must be taken before the step rewrites B_inv or appends to U / R."""
    if opts.pricing != "steepest" or state.e is None:
        return None
    span = spans.start("weights")
    u = alpha @ state.B_inv
    if defer:
        u = u + (alpha @ state.U.T) @ state.R
    spans.stop(span)
    return u


def _update_weights(prob, state, opts, backend, p, e_p, alpha, u, row, q, do_pivot):
    """The post-pivot e and gamma (``simplex_tpu.core.step.pivot_step``'s
    incremental pricing block): ``row`` is row q of the true pre-pivot
    inverse, ``q`` the leaving row, ``u`` from :func:`_pre_pivot_u`; every
    index is read from the PRE-pivot state. Unchanged unless ``do_pivot``."""
    qv = q.view(1)
    alpha_q = alpha.index_select(0, qv).view(())
    safe_aq = torch.where(do_pivot, alpha_q, 1)
    inv_aq = 1 / safe_aq
    rho = row * inv_aq
    if u is not None:
        w, v = backend.pricing_update2(prob.A, rho, u)
    else:
        w = backend.pricing_update(prob.A, rho)
    e_new = state.e - e_p * w
    if u is not None:
        gp1 = 1 + torch.dot(alpha, alpha)
        lv = state.basis.index_select(0, qv).long()
        gamma_lv = 1 + (gp1 - safe_aq * safe_aq) * (inv_aq * inv_aq)
        gse = state.gamma - 2 * w * v + (w * w) * gp1
        # floored at the provable minimum 1 (the three-term recurrence can
        # cancel below it), capped like devex
        gamma_new = gse.index_copy(0, lv, gamma_lv.view(1)).clamp(1.0, 1e30)
    else:
        gamma_p = backend.gather_cost(state.gamma, p)
        # capped: the weights grow multiplicatively and would overflow fp32
        gamma_new = torch.maximum(state.gamma, (w * w) * gamma_p.clamp_min(1)).clamp(1.0, 1e30)
    return torch.where(do_pivot, e_new, state.e), torch.where(do_pivot, gamma_new, state.gamma)


def _refill(prob, state, opts, ctl, bland):
    """Refill the multiple-pricing buffer (``simplex_tpu.core.step.
    _multi_pricing``'s ``_fill``): the K most improving columns of one
    pricing pass -- a shadow segment (rotating per refill), else the full
    shadow, else exact fp32, each stage taken when the one before found no
    candidate that improves exactly -- then one (m, m) x (m, K) ftran
    against the base inverse, flushed first when the pending pairs are at
    capacity. Returns ``(min_exact, state, npend)`` with the new buffer in
    ``state.cand``; ``min_exact`` is the exact minimum reduced cost when the
    exact pass ran, else -inf. Under bounds candidates are chosen, checked
    and ranked by their signed reduced costs."""
    cand = state.cand
    K = cand.idx.shape[0]
    n = prob.A.shape[1]
    dtype = state.B_inv.dtype
    eps = opts.resolve_eps()
    y = state.y

    def recheck(negv, idx):
        # exact reduced costs of the chosen columns (O(K m)); the masked
        # selection values veto penalized basics (half-penalty cut)
        A_c = _ops.gather_columns(prob.A, idx).to(dtype)
        e1 = y @ A_c - prob.c.index_select(0, idx).to(dtype)
        valid = (_signed(state, e1, idx) < -eps) & (-negv.to(dtype) < 0.5 * _ops.BASIC_PENALTY)
        return idx, e1, valid, A_c

    def shadow_pick(lo, hi):
        # top-K of the shadow's masked signed reduced costs over [lo, hi)
        A_sh = prob.A_price if (lo, hi) == (0, n) else prob.A_price[:, lo:hi]
        e_sh = _ops.reduced_costs(y, A_sh, prob.c[lo:hi]).to(dtype)
        if state.at_upper is not None:
            e_sh = torch.where(state.at_upper[lo:hi], -e_sh, e_sh)
        negv, loc = _ops.top_k(-_ops.add_basic_penalty(e_sh, state.basis, lo), K)
        return recheck(negv, loc + lo)

    fill, min_exact = None, -math.inf
    if prob.A_price is not None and not bland:
        S = opts.partial_pricing
        seg_ok = not isinstance(prob.A_price, _sp.SparseA)
        if seg_ok and S > 1 and n % S == 0 and n // S >= max(opts.partial_min_segment, K):
            w = n // S
            lo = (ctl.seg % S) * w
            fill = shadow_pick(lo, lo + w)
            if not read_flag(fill[2].any()):
                fill = None
        if fill is None:
            fill = shadow_pick(0, n)
            if not read_flag(fill[2].any()):
                fill = None
    if fill is None:
        e_all = _ops.reduced_costs(y, prob.A, prob.c).to(dtype)
        s_all = _ops.add_basic_penalty(_signed(state, e_all), state.basis)
        min_exact = s_all.min()
        if bland:
            # Bland's rule needs the LOWEST improving index: a buffer of that
            # one candidate (the refill then recurs every pivot)
            imp = s_all < -eps
            p_b = torch.argmax(imp.to(torch.int32)).to(torch.int32)
            idx = p_b.view(1).expand(K).contiguous()
            e_sel = e_all.index_select(0, idx)
            valid = torch.zeros(K, dtype=torch.bool, device=y.device)
            valid[0] = imp.any()
        else:
            negv, idx = _ops.top_k(-s_all, K)
            e_sel = e_all.index_select(0, idx)
            valid = -negv < -eps
        fill = (idx, e_sel, valid, _ops.gather_columns(prob.A, idx).to(dtype))
    idx, e_sel, valid, A_cols = fill

    B_inv, U, R, npend_t = state.B_inv, state.U, state.R, state.npend
    npend = ctl.npend
    if npend >= opts.resolve_defer():
        # the pending buffer is full: fold it into the base first
        B_inv.addmm_(U.T, R)
        U, R, npend = torch.zeros_like(U), torch.zeros_like(R), 0
        npend_t = torch.zeros_like(npend_t)
    alpha = B_inv @ A_cols  # (m, K) base ftrans, full fp32
    cand = CandBuffer(
        idx=idx,
        alpha=alpha.T,
        acols=A_cols.T,
        e=e_sel,
        valid=valid,
        e0=torch.where(valid, _signed(state, e_sel, idx), 0.0).min(),
        seg=cand.seg + 1,
    )
    state = dataclasses.replace(state, B_inv=B_inv, U=U, R=R, npend=npend_t, cand=cand)
    return min_exact, state, npend


def _multi_pricing(prob, state, opts, ctl, bland):
    """The entering column from the candidate buffer, refilled first when
    ``ctl.need_refill``. Returns ``(p, min_e, alpha0_p, state, npend)``:
    ``min_e`` is the chosen candidate's reduced cost, or the exact minimum
    when an exact refill found none improving; ``alpha0_p`` its base
    ftran. Under bounds the criterion is the signed reduced cost."""
    min_exact, npend = math.inf, ctl.npend
    if ctl.need_refill:
        min_exact, state, npend = _refill(prob, state, opts, ctl, bland)
    cand = state.cand
    s2 = torch.where(cand.valid, _signed(state, cand.e, cand.idx), math.inf)
    j = torch.argmin(s2).view(1)
    s_j = s2.index_select(0, j).view(())
    min_e = torch.where(torch.isfinite(s_j), s_j, min_exact)
    p = cand.idx.index_select(0, j).view(())
    return p, min_e, cand.alpha.index_select(0, j).view(-1), state, npend


def _flush(B_inv, U, R, npend):
    """B_inv += U.T R in place (one GEMM; the JAX step flushes when an append
    filled the buffer); returns ``(U, R, npend)`` zeroed."""
    B_inv.addmm_(U.T, R)
    return torch.zeros_like(U), torch.zeros_like(R), torch.zeros_like(npend)


def _finish_unbounded(prob, state, opts, backend, alpha, u, min_e, e_p, c_p, p, defer, npend):
    """The unbounded step without multiple pricing, from its ftran on: the
    whole O(m) tail in one backend call (``pivot_tail``: one launch on the
    hopper backend), then the inverse's update -- the rank-1 kernel, or,
    under deferred updates, the pair the tail wrote into slot ``npend`` and
    the flush when that filled the buffer. Under devex / steepest edge the
    e / gamma update follows from what the tail returns (row q copied out
    before the update, q, take) and ``u`` (:func:`_pre_pivot_u`)."""
    extra = {}
    if defer:
        extra = dict(U=state.U, R=state.R, npend=npend, npend_t=state.npend)
    span = spans.start("tail")
    t = backend.pivot_tail(
        state.x_b, alpha, state.basis, state.y, state.c_b, state.B_inv,
        min_e, e_p, c_p, p, state.iters, state.degen,
        eps=opts.resolve_eps(), pivot_tol=opts.pivot_tol, feas_tol=opts.feas_tol,
        harris=opts.ratio == "harris", degen_tol=opts.degen_tol,
        bland_after=opts.bland_after, **extra,
    )
    spans.stop(span)
    span = spans.start("update")
    U, R, npend_new = state.U, state.R, t.npend
    if defer:
        B_inv = state.B_inv
        if npend + 1 >= opts.resolve_defer():
            # a step that does not pivot is terminal: its zero pair leaves
            # the true inverse unchanged
            U, R, npend_new = _flush(B_inv, U, R, npend_new)
    else:
        # a no-op when not pivoting: eta and row are zero then
        B_inv = backend.rank1_update(state.B_inv, t.eta, t.row)
    spans.stop(span)
    e, gamma = state.e, state.gamma
    if _weighted_active(opts, state):
        span = spans.start("weights")
        e, gamma = _update_weights(
            prob, state, opts, backend, p, e_p, alpha, u, t.row, t.q, t.take
        )
        spans.stop(span)
    return SolverState(
        B_inv=B_inv, x_b=t.x_b, y=t.y, c_b=t.c_b, basis=t.basis, iters=t.iters,
        status=t.status, degen=t.degen, last_refac=state.last_refac,
        U=U, R=R, npend=npend_new, at_upper=None, cand=state.cand, pert=state.pert,
        e=e, gamma=gamma,
    )


def pivot_step(
    prob: Problem,
    state: SolverState,
    opts: SimplexOptions,
    backend,
    ctl: Optional[Control] = None,
) -> SolverState:
    """Apply one pivot, or set a terminal status. ``ctl`` is this state's
    :func:`read_control` (read here when not given). Updates
    ``state.B_inv``, ``state.U`` and ``state.R`` in place and returns the
    new state.

    Where the backend's :class:`~simplex_tpu_torch.core.graph.StepGraphs`
    take the step, it runs through them: its O(m) leaves and scalars then
    lie in buffers that a later step writes again, and stay valid through
    the next step only (``core.solver._pivot_loop`` copies the state it
    returns out of them)."""
    if ctl is None:
        ctl = read_control(state, opts, prob, backend)
    graphs = getattr(backend, "step_graphs", None)
    if graphs is not None and graphs.takes(prob, state, opts, ctl):
        return graphs.step(prob, state, opts, backend, ctl)
    graph_steps["eager"] += 1
    return eager_step(prob, state, opts, backend, ctl)


def eager_step(
    prob: Problem, state: SolverState, opts: SimplexOptions, backend, ctl: Control
) -> SolverState:
    """:func:`pivot_step` op by op: the definition that a step graph
    records."""
    dtype = state.B_inv.dtype
    eps = opts.resolve_eps()
    bland = bland_on(opts, ctl.degen)
    use_bland = _const_flag(state.degen.device, bland)
    multi = _multi_active(opts, state)
    defer = opts.update_defer > 0 or multi
    bounded = prob.u is not None
    npend = ctl.npend

    # ---- pricing over the nonbasic columns (signed under bounds) ----
    span = spans.start("price")
    col = None
    if multi:
        p, min_e, alpha0_p, state, npend = _multi_pricing(prob, state, opts, ctl, bland)
        cand_mid = state.cand
    elif _weighted_active(opts, state):
        p, min_e, col = _price_weighted(prob, state, opts, use_bland, bland, ctl, backend)
    elif bounded:
        p, min_e = _price_bounded(prob, state, opts, use_bland, bland, ctl, backend)
    elif prob.A_price is not None and not _partial_active(opts, prob):
        p, min_e, col = _price_shadow(prob, state, opts, use_bland, bland, backend)
    elif _partial_active(opts, prob):
        p, min_e, col = _price_segment(prob, state, opts, use_bland, bland, ctl, backend)
    else:
        p, min_e = backend.choose_entering(
            state.y, prob.A, prob.c, eps, use_bland, state.basis
        )
    spans.stop(span)

    # ---- ftran ----
    # e_p == min_e under Dantzig
    span = spans.start("ftran")
    A_p, c_p, e_p = col if col is not None else _entering_column(prob, state, p, backend)
    if multi:
        # the buffered base column plus every pending pair: O(L m), no m^2 read
        alpha = alpha0_p + state.U.T @ (state.R @ A_p)
    elif defer:
        # the true inverse is B_inv + U.T R
        alpha = torch.mv(state.B_inv, A_p) + state.U.T @ (state.R @ A_p)
    else:
        alpha = torch.mv(state.B_inv, A_p)
    spans.stop(span)

    # steepest edge: before anything below rewrites B_inv, U or R
    u_se = _pre_pivot_u(state, opts, alpha, defer)

    if not multi and not bounded:
        return _finish_unbounded(
            prob, state, opts, backend, alpha, u_se, min_e, e_p, c_p, p, defer, npend
        )

    # ---- ratio test (+ eta and the stepped x_b) ----
    span = spans.start("tail")
    optimal = min_e >= -eps
    if bounded:
        # d = sigma alpha: an entering column that leaves its upper bound
        # decreases, so every basic value moves the other way
        from_upper = state.at_upper.index_select(0, p.view(1)).view(())
        d_vec = torch.where(from_upper, -alpha, alpha)
        u_p = backend.gather_cost(prob.u, p).to(dtype)
        q, theta_q, unbounded, flip, leave_upper = backend.ratio_argmin_bounded(
            state.x_b, d_vec, prob.u.index_select(0, state.basis).to(dtype), u_p,
            state.basis, opts.pivot_tol, use_bland, opts.ratio == "harris",
            opts.feas_tol,
        )
    else:
        q, theta_q, unbounded, eta, x_b_new = backend.ratio_eta(
            state.x_b, alpha, state.basis, opts.pivot_tol, use_bland,
            opts.ratio == "harris", opts.feas_tol,
        )

    take = ~optimal & ~unbounded
    # numerical failure: a non-finite pricing value, or a pivot about to be
    # taken with a non-finite ratio
    bad = ~torch.isfinite(min_e) | (take & ~torch.isfinite(theta_q))
    take = take & ~bad
    if multi:
        # exact entry recheck at eps/2 (looser than the refill's eps, so a
        # candidate straddling -eps cannot livelock refill and rejection);
        # a rejected skip counts toward the degenerate streak below
        s_p = torch.where(from_upper, -e_p, e_p) if bounded else e_p
        cand_fresh = s_p < -(eps * 0.5)
        take = take & (cand_fresh | use_bland)
    # a bound flip changes no basis: the inverse, y, c_b and basis move
    # only on do_pivot; x_b and at_upper also move on a flip
    do_pivot = take & ~flip if bounded else take

    alpha_q = alpha.index_select(0, q.view(1)).view(())
    inv_aq = 1 / torch.where(do_pivot, alpha_q, 1)
    theta_safe = torch.where(take, theta_q, 0)
    is_q = torch.arange(state.basis.shape[0], device=q.device) == q
    if bounded:
        eta = torch.where(is_q, inv_aq - 1, -alpha * inv_aq)
        x_b_step = state.x_b - theta_safe * d_vec
        # the entering value: theta above 0, or u_p - theta below u_p
        x_p = torch.where(from_upper, u_p - theta_safe, theta_safe)
        x_b_new = torch.where(is_q, x_p, x_b_step)
    # row q of the OLD inverse, as a copy: the update below rewrites B_inv
    binv_q = state.B_inv.index_select(0, q.view(1)).view(-1)
    if defer:
        # row q of the TRUE inverse: base row + pending corrections
        binv_q = binv_q + state.U.index_select(1, q.view(1)).view(-1) @ state.R
    spans.stop(span)

    # ---- B_inv update, a no-op when not pivoting ----
    span = spans.start("update")
    U, R, npend_new = state.U, state.R, state.npend
    if defer:
        # append (eta, row) at slot npend; a zero pair when not pivoting
        U[npend] = torch.where(do_pivot, eta, 0)
        R[npend] = torch.where(do_pivot, binv_q, 0)
        npend_new = state.npend + do_pivot.to(torch.int32)
        B_inv = state.B_inv
        if not multi and npend + 1 >= opts.resolve_defer():
            # a step that does not pivot is terminal or a bound flip: its
            # zero pair leaves the true inverse unchanged
            U, R, npend_new = _flush(B_inv, U, R, npend_new)
    else:
        B_inv = backend.rank1_update(
            state.B_inv,
            torch.where(do_pivot, eta, 0),
            torch.where(do_pivot, binv_q, 0),
        )
    spans.stop(span)

    # ---- O(m) updates ----
    span = spans.start("tail")
    y_new = state.y - (e_p * inv_aq) * binv_q
    at_q = is_q & do_pivot
    if bounded:
        do_flip = take & flip
        x_b_out = torch.where(do_pivot, x_b_new, torch.where(do_flip, x_b_step, state.x_b))
        # p: cleared when it enters, toggled when it flips; the leaving
        # column: at its upper bound when it left there
        cols = torch.arange(prob.A.shape[1], device=q.device)
        lv = state.basis.index_select(0, q.view(1))
        at_upper = torch.where(
            (cols == p) & take,
            do_flip & ~from_upper,
            torch.where((cols == lv) & do_pivot, leave_upper, state.at_upper),
        )
    else:
        x_b_out = torch.where(take, x_b_new, state.x_b)
        at_upper = None
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
    degen_keep = state.degen
    cand_new = state.cand
    if multi:
        degen_keep = torch.where(
            ~cand_fresh & (status == int(SolveStatus.RUNNING)), state.degen + 1, state.degen
        )
        # exact reduced-cost update of every candidate from the true row q;
        # the entering candidate, and one that failed its recheck, drop out
        w_c = cand_mid.acols @ binv_q
        drop = do_pivot | (~cand_fresh & ~optimal)
        cand_new = dataclasses.replace(
            cand_mid,
            e=torch.where(do_pivot, cand_mid.e - (e_p * inv_aq) * w_c, cand_mid.e),
            valid=torch.where(drop, cand_mid.valid & (cand_mid.idx != p), cand_mid.valid),
        )
    spans.stop(span)
    e_out, gamma_out = state.e, state.gamma
    if _weighted_active(opts, state):
        span = spans.start("weights")
        e_out, gamma_out = _update_weights(
            prob, state, opts, backend, p, e_p, alpha, u_se, binv_q, q, do_pivot
        )
        spans.stop(span)
    return SolverState(
        B_inv=B_inv,
        x_b=x_b_out,
        y=torch.where(do_pivot, y_new, state.y),
        c_b=torch.where(at_q, c_p, state.c_b),
        basis=torch.where(at_q, p, state.basis),
        iters=state.iters + take.to(torch.int32),
        status=status,
        degen=torch.where(take, degen_new, degen_keep),
        last_refac=state.last_refac,
        U=U,
        R=R,
        npend=npend_new,
        at_upper=at_upper,
        cand=cand_new,
        pert=state.pert,
        e=e_out,
        gamma=gamma_out,
    )


def _effective_rhs(prob: Problem, state: SolverState, dtype) -> torch.Tensor:
    """The rhs the basic variables solve against: b - A x_N (b when the
    problem has no upper bounds; one O(mn) matvec otherwise), plus the
    active perturbation shift w."""
    b = bounded_rhs(prob, state.at_upper, dtype)
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
    if prob.u is not None:
        # toward the farther bound, at most a quarter of the room, so the
        # shifted point never crosses a bound
        u_b = prob.u.index_select(0, state.basis).to(dtype)
        room_up = (u_b - state.x_b).clamp_min(0)  # inf when unbounded above
        room_dn = state.x_b.clamp_min(0)
        go_up = ~torch.isfinite(room_up) | (room_up >= room_dn)
        delta = torch.minimum(delta, 0.25 * torch.where(go_up, room_up, room_dn))
        delta = torch.where(go_up, delta, -delta)
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


def _invalidate_candidates(state: SolverState) -> SolverState:
    """Empty the candidate buffer: its columns and reduced costs were taken
    against the old representation, so the next pivot refills."""
    if state.cand is None:
        return state
    cand = dataclasses.replace(state.cand, valid=torch.zeros_like(state.cand.valid))
    return dataclasses.replace(state, cand=cand)


def refactorize(
    prob: Problem, state: SolverState, backend, defer: bool = False,
    pricing: str = "dantzig",
) -> SolverState:
    """Re-invert the true basis (Newton-Schulz seeded with the drifted
    inverse, the pending pairs folded in when ``defer``), re-derive x_b and
    y from it, drop the pending pairs and empty the candidate buffer. Under
    devex / steepest edge (``pricing``) also re-derive e exactly; devex
    resets its reference weights to 1, steepest edge keeps gamma (the true
    norms depend on the basis alone)."""
    dtype = state.B_inv.dtype
    B = backend.gather_basis_matrix(prob.A, state.basis).to(dtype)
    seed = state.B_inv
    if defer:
        seed = torch.addmm(seed, state.U.T, state.R)
    B_inv, _ = inverse_newton(B, seed=seed)
    new = dataclasses.replace(
        state,
        B_inv=B_inv,
        # no clamp: x_b must stay the exact basic solution
        x_b=B_inv @ _effective_rhs(prob, state, dtype),
        y=state.c_b @ B_inv,
        last_refac=state.iters.clone(),
    )
    if defer:
        new.U, new.R = torch.zeros_like(state.U), torch.zeros_like(state.R)
        new.npend = torch.zeros_like(state.npend)
    if pricing in ("devex", "steepest") and state.e is not None:
        new.e = _ops.pricing_update(prob.A, new.y) - prob.c.to(dtype)
        if pricing == "devex":
            new.gamma = torch.ones_like(state.gamma)
    return _invalidate_candidates(new)


def recompute_xy(prob: Problem, state: SolverState, defer: bool = False) -> SolverState:
    """Refresh x_b and y from the current inverse (two O(m^2) products,
    plus the O(L m) pending corrections when ``defer``); empties the
    candidate buffer, whose reduced costs ride on y."""
    dtype = state.B_inv.dtype
    b = _effective_rhs(prob, state, dtype)
    x_b = state.B_inv @ b
    y = state.c_b @ state.B_inv
    if defer:
        x_b = x_b + state.U.T @ (state.R @ b)
        y = y + (state.c_b @ state.U.T) @ state.R
    return _invalidate_candidates(dataclasses.replace(state, x_b=x_b, y=y))
