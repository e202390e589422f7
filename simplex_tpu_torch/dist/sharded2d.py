"""2-D sharded solve: pricing over all ranks, B_inv's rows over "rows".

The counterpart of ``simplex_tpu.dist.sharded2d``. On a mesh ("rows" R,
"cols" C) of D = R C ranks (:func:`~simplex_tpu_torch.dist.mesh.make_mesh`
with ``axis_names=("rows", "cols"), shape=(R, C)``):

    A, c, e, gamma   columns split over the flattened mesh (rank (r, k)
                     holds shard r C + k; shards may differ by one column)
    B_inv (m, m)     rows split over "rows" (m / R each, replicated over
                     "cols"); x_b, c_b and the basis likewise; U's columns
    y, b, R          replicated

so a rank prices n / D columns and updates m / R rows of the inverse. This
module runs the reference's own loop body (``_solve_2d_local``), not the
single solve's step: no degenerate-streak perturbation, no periodic
recompute; Bland's rule after ``bland_after`` degenerate pivots,
``refactor_every`` through the distributed Newton-Schulz
(:func:`refactorize_2d`), and at most four verify-terminal rounds. A pivot
(Dantzig, eager updates) takes six collectives, in the reference's order:

  basis mask    SUM over "rows" of the row blocks' basis ids (m ints)
  pricing       ``pricing_scan`` on the rank's columns (the whole matrix's
                row chunks), then ONE MIN over all ranks of the (min e,
                global index) and Bland keys (the 1-D mode's backend)
  column        ONE owner-masked SUM over all ranks of A_p and c_p
  ratio pass 1  ONE MIN over "rows": the no-candidate flag, min theta and
                (Harris) the relaxed bound
  ratio pass 2  ONE MIN over "rows": the (-alpha, row) key of Harris's
                largest pivot (or classic's first minimum) and Bland's
                (basis id, row) key
  pivot row     ONE owner-masked SUM over "rows" of row q of B_inv with
                alpha_q, theta_q and (deferred updates) u_q

then ``rank1_update`` on the rank's (m / R, m) row block (eager), or the
pair appended to U / R with the in-place flush (``update_defer``). The
bf16 shadow, segments of the local shard, devex (the pick's keys in the
control read, gamma_p's SUM) and multiple pricing (exact refills of the
local shard, the per-rank top-K merged in one SUM of packed keys, the K
columns in one (m + 1, K) SUM, minor pivots with no pricing collective)
follow the reference. Every host branch reads replicated values: one
control read a pivot plus the shadow / segment rechecks' counted reads
(``core.step.host_reads``). Each value a branch depends on is bit for bit
the same on every rank: owner-masked sums, MIN / MAX, and row-ordered
gathers; collectives are counted by op in ``dist.sharded.collectives``.
Every MIN's keys are of the working dtype (``dist.sharded.key_codec``: one
packed int64 and an all-reduce MIN in float32; int64 pairs, one
all-gather and a lexicographic minimum in float64), so that theta's
minimum and the Harris bound come back exact and ``theta == tmin`` finds
the rows that attain it in float64 too.

Shards of A may be uneven (``torch.tensor_split``'s split over the
flattened mesh) where the reference asks for n divisible by R C; m must
divide by R (the all-gathers of the re-inversion take equal row blocks), as
in the reference. Sparse A (scipy.sparse, a sparse tensor or a
:class:`~simplex_tpu_torch.sparse.SparseA`) gives each rank CSR of its own
columns; segments and the bf16 shadow are off on it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch import spans
from simplex_tpu_torch.config import DEFAULT_OPTIONS, SimplexOptions, check_supported, pin_full_fp32
from simplex_tpu_torch.core import step as _step_mod
from simplex_tpu_torch.core.solver import MAX_VERIFY_ROUNDS, SolveResult, finalize_result
from simplex_tpu_torch.core.state import Problem, SolverState, with_pricing_shadow
from simplex_tpu_torch.dist.mesh import COLS_AXIS, ROWS_AXIS, flat_group, require_mesh
from simplex_tpu_torch.dist.sharded import (
    _LOW32,
    _NONE,
    _local_columns,
    all_gather,
    all_reduce,
    default_device,
    key_codec,
    make_collective_backend,
    shard_bounds,
)
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.logging import get_logger
from simplex_tpu_torch.status import SolveStatus

INT_MAX = _ops.INT_MAX
NS_MAX_ITER = 60  # Newton-Schulz iterations of one re-inversion (the reference's cap)

_RUNNING = int(SolveStatus.RUNNING)


def _check_2d_shapes(shape, R: int, C: int) -> None:
    m, n = shape
    if m % R != 0:
        raise ValueError(f"shapes must divide the mesh: m={m} by R={R}")
    if n < R * C:
        raise ValueError(f"shapes must divide the mesh: n={n} columns over R*C={R * C} ranks")


@dataclasses.dataclass
class Ctx:
    """One rank's part of a 2-D solve: its shards, groups and options."""

    opts: SimplexOptions
    m: int
    n: int
    R: int
    C: int
    r_ix: int  # the rank's coordinate along "rows"
    lo: int  # its columns [lo, hi) of A
    hi: int
    prob: Problem  # A's columns [lo, hi) (and their shadow), b, c[lo:hi]
    rows: object  # the "rows" group
    everyone: object  # the group of all ranks (the flattened mesh)
    rows_order: list  # rows-group position -> row block, for ordered gathers
    slot: int  # the rank's place along the flattened mesh
    backend: object  # the 1-D mode's collective backend over all ranks
    keys: object  # the MINs' keys in the working dtype (dist.sharded.key_codec)
    partial: bool
    K: int  # multiple-pricing buffer (0 = off)
    L: int  # pending-pair buffer (0 = eager)

    @property
    def m_loc(self) -> int:
        return self.m // self.R

    @property
    def row_base(self) -> int:
        return self.r_ix * self.m_loc

    @property
    def device(self) -> torch.device:
        return self.prob.b.device

    @property
    def dtype(self) -> torch.dtype:
        return self.opts.dtype


def _rows_sum(cx: Ctx, t: torch.Tensor, name: str) -> torch.Tensor:
    return all_reduce(t, dist.ReduceOp.SUM, cx.rows, name)


def _rows_gather(cx: Ctx, t: torch.Tensor, name: str) -> torch.Tensor:
    """The row blocks ``t`` of every rank of the rank's "rows" group,
    stacked in row-block order: (R * len(t), ...)."""
    parts = all_gather(t, cx.rows, name)
    return parts[[cx.rows_order.index(r) for r in range(cx.R)]].flatten(0, 1)


def _own_rows(cx: Ctx, q: torch.Tensor):
    """(row q in this rank's block, its local position clamped into it)."""
    loc = q.to(torch.int64) - cx.row_base
    return (loc >= 0) & (loc < cx.m_loc), loc.clamp(0, cx.m_loc - 1)


def basis_full(cx: Ctx, s: dict) -> torch.Tensor:
    """The whole (m,) basis from the row blocks: one int SUM over "rows"."""
    buf = torch.zeros(cx.m, dtype=torch.int32, device=cx.device)
    buf[cx.row_base : cx.row_base + cx.m_loc] = s["basis"] + 1
    return _rows_sum(cx, buf, "basis_rows") - 1


def _need_refill(cx: Ctx, s: dict) -> torch.Tensor:
    """``simplex_tpu/dist/sharded2d.py:335-346``: no buffered candidate
    still delivers ``multi_price_stale`` of the refill-time improvement,
    Bland's rule is on, a degenerate streak, or the pending pairs are full."""
    eps = cx.opts.resolve_eps()
    best_now = torch.where(s["cvalid"], s["ce"], math.inf).min()
    thresh = torch.clamp_max(cx.opts.multi_price_stale * s["ce0"], -eps)
    return (
        (best_now > thresh)
        | _step_mod._use_bland(cx.opts, s["degen"])
        | (s["degen"] >= max(cx.opts.multi_price_degen, 1))
        | (s["npend"] >= cx.L)
    )


def _entering(cx: Ctx, s: dict, p: torch.Tensor):
    """``(A_p, c_p, e_p)``: column p from its owner (one SUM over all
    ranks) and its exact reduced cost."""
    A_p, c_p = cx.backend.gather_column_cost(cx.prob.A, cx.prob.c, p)
    return A_p, c_p, torch.dot(s["y"], A_p) - c_p


def _devex_pick(cx: Ctx, s: dict, bfull: torch.Tensor):
    """The devex pick from the maintained e and gamma (one MIN over all
    ranks), its column and exact recheck; ``(pick, stale)``."""
    eps = cx.opts.resolve_eps()
    p1, min1 = cx.backend.devex_choose(s["e"], s["gamma"], eps, _step_mod._const_flag(cx.device, False))
    col = _entering(cx, s, p1)
    stale = (min1 >= -eps) | (col[2] >= -eps) | (bfull == p1).any()
    return (p1, col[2], col), stale


class Control(NamedTuple):
    """The loop's and the next step's replicated scalars, from one read."""

    status: int
    iters: int
    degen: int
    last_refac: int
    npend: int = 0
    need_refill: bool = False
    stale: bool = False
    pick: Optional[tuple] = None  # devex: (p, e_p, (A_p, c_p, e_p)) on the device
    basis: Optional[torch.Tensor] = None  # devex: the whole basis


def read_control(cx: Ctx, s: dict) -> Control:
    """One device-to-host read of replicated values: the counters, and the
    next step's branch flags (the refill under multiple pricing; under
    devex the pick, made here with its collectives, and its stale flag)."""
    fields = {k: s[k] for k in ("status", "iters", "degen", "last_refac")}
    if cx.L:
        fields["npend"] = s["npend"]
    if cx.K:
        fields["need_refill"] = _need_refill(cx, s)
    pick = bfull = None
    if cx.opts.pricing == "devex":
        bfull = basis_full(cx, s)
        pick, fields["stale"] = _devex_pick(cx, s, bfull)
    packed = torch.stack([v.to(torch.int32) for v in fields.values()])
    span = spans.start("read", "control")
    vals = packed.tolist()
    spans.stop(span)
    _step_mod.host_reads["control"] += 1
    ctl = dict(zip(fields, vals))
    for k in ("need_refill", "stale"):
        if k in ctl:
            ctl[k] = bool(ctl[k])
    return Control(**ctl, pick=pick, basis=bfull)


# ---- pricing ---------------------------------------------------------------


def _exact(cx: Ctx, s: dict, bfull: torch.Tensor, use_bland: torch.Tensor):
    """One exact pass over the rank's columns, the winner agreed over all
    ranks: ``(p, min_e)``."""
    return cx.backend.choose_entering(
        s["y"], cx.prob.A, cx.prob.c, cx.opts.resolve_eps(), use_bland, bfull
    )


def _price(cx: Ctx, s: dict, ctl: Control, bland: bool, use_bland: torch.Tensor):
    """The entering column under every rule but multiple pricing:
    ``(p, min_e, col)``, ``col`` the winner's ``_entering`` when the
    recheck computed it, else None."""
    opts, prob = cx.opts, cx.prob
    eps = opts.resolve_eps()
    if opts.pricing == "devex":
        if not bland and not ctl.stale:
            return ctl.pick
        return (*_exact(cx, s, ctl.basis, use_bland), None)
    bfull = basis_full(cx, s)
    if bland or (not cx.partial and prob.A_price is None):
        return (*_exact(cx, s, bfull, use_bland), None)
    A_src = prob.A_price if prob.A_price is not None else prob.A
    if cx.partial:
        # segment (iters mod S) of the local shard, then one exact pass
        w = (cx.hi - cx.lo) // opts.partial_pricing
        lo = (ctl.iters % opts.partial_pricing) * w
        p1, _ = cx.backend.choose_entering(
            s["y"], A_src[:, lo : lo + w], prob.c[lo : lo + w], eps, use_bland, bfull, lo
        )
    else:
        p1, _ = cx.backend.choose_entering(s["y"], A_src, prob.c, eps, use_bland, bfull)
    col = _entering(cx, s, p1)
    if not _step_mod.read_flag(col[2] >= -eps):
        return p1, col[2], col
    return (*_exact(cx, s, bfull, use_bland), None)


def _refill(cx: Ctx, s: dict, ctl: Control, bland: bool):
    """``simplex_tpu/dist/sharded2d.py:238-325``: exact reduced costs of
    the local shard, the per-rank top-K merged over all ranks (one SUM of
    packed (e, index) keys, each rank in its slot, with Bland's first index
    and the exact minimum), the K columns and costs in one (m + 1, K) SUM;
    the flush when the pending buffer is full, then the base ftran of the
    rank's row block. Returns ``(min_exact, state)``."""
    dev, dtype, K = cx.device, cx.dtype, cx.K
    eps = cx.opts.resolve_eps()
    n_loc = cx.hi - cx.lo
    e_loc = _ops.add_basic_penalty(
        _ops.reduced_costs(s["y"], cx.prob.A, cx.prob.c).to(dtype), basis_full(cx, s), cx.lo
    )
    cols = torch.arange(cx.lo, cx.hi, device=dev)
    kc = cx.keys
    top = kc.smallest(kc.pack(e_loc, cols), K)
    neg = e_loc < -eps
    first = torch.where(neg.any(), torch.argmax(neg.to(torch.int32)).to(torch.int64) + cx.lo, _NONE)
    mine = torch.cat([top, kc.plain(first.view(1)), kc.pack(e_loc.min().view(1), 0)])
    slots = torch.zeros((cx.R * cx.C, *mine.shape), dtype=torch.int64, device=dev)
    slots[cx.slot] = mine
    slots = all_reduce(slots, dist.ReduceOp.SUM, cx.everyone, "refill_topk")
    best = kc.smallest(slots[:, :K].reshape(-1, *mine.shape[1:]), K)
    cidx = kc.index(best).to(torch.int32)
    valid = kc.value(best) < -eps
    min_exact = kc.value(kc.smallest(slots[:, K + 1], 1)[0])
    if bland:
        # the single lowest improving index, refilled every pivot
        p_b = kc.plain_of(slots[:, K]).min()
        any_b = p_b != _NONE
        cidx = torch.where(any_b, p_b, 0).to(torch.int32).expand(K).contiguous()
        valid = torch.zeros(K, dtype=torch.bool, device=dev)
        valid[0] = any_b
    loc = cidx.to(torch.int64) - cx.lo
    own = (loc >= 0) & (loc < n_loc)
    loc = loc.clamp(0, n_loc - 1)
    buf = torch.cat([
        _ops.gather_columns(cx.prob.A, loc).to(dtype),
        cx.prob.c.index_select(0, loc).to(dtype).view(1, K),
    ])
    buf = all_reduce(torch.where(own[None, :], buf, 0), dist.ReduceOp.SUM, cx.everyone, "refill_columns")
    acols, ccost = buf[:-1], buf[-1]
    ce = s["y"] @ acols - ccost
    s = dict(s)
    if ctl.npend >= cx.L:
        s["B_inv"].addmm_(s["U"].T, s["R"])
        s["U"], s["R"] = torch.zeros_like(s["U"]), torch.zeros_like(s["R"])
        s["npend"] = torch.zeros_like(s["npend"])
    s.update(
        cidx=cidx, ce=ce, cvalid=valid, ce0=torch.where(valid, ce, 0.0).min(), cacols=acols,
        ccost=ccost, calpha=s["B_inv"] @ acols,
    )
    return min_exact, s


# ---- the step ---------------------------------------------------------------


def _ratio_rows(cx: Ctx, s: dict, alpha: torch.Tensor, bland: bool):
    """The distributed ratio test over "rows" (``simplex_tpu/dist/
    sharded2d.py:468-524``): ``(q, theta, unbounded)``, q the global
    leaving row (0 when none) and theta the rank's ratios."""
    opts, dev = cx.opts, cx.device
    mask = alpha > opts.pivot_tol
    x_pos = torch.clamp_min(s["x_b"], 0)
    safe = torch.where(mask, alpha, 1)
    theta = torch.where(mask, x_pos / safe, math.inf)
    harris = opts.ratio == "harris"
    kc = cx.keys
    # theta's minimum and the Harris bound travel as keys of the working
    # dtype, so that tmin is the minimum itself and theta == tmin finds it
    pass1 = [kc.plain((~mask.any()).view(1)), kc.pack(theta.min().view(1), 0)]
    if harris:
        relaxed = torch.where(mask, (x_pos + opts.feas_tol) / safe, math.inf).min()
        pass1.append(kc.pack(relaxed.view(1), 0))
    pass1 = kc.reduce(torch.cat(pass1), cx.rows, "ratio_rows")
    unbounded = kc.plain_of(pass1[0]) == 1
    tmin = kc.value(pass1[1])
    rows = torch.arange(cx.row_base, cx.row_base + cx.m_loc, device=dev)
    if harris:
        ok = mask & (theta <= kc.value(pass1[2]))
        amax = torch.where(ok, alpha, -math.inf).max()
        i_loc = torch.where(ok & (alpha == amax), rows, INT_MAX).min()
        pass2 = [kc.pack((-amax).view(1), i_loc.view(1))]
    else:
        pass2 = [kc.plain(torch.where(theta == tmin, rows, INT_MAX).min().view(1))]
    if bland:
        # the lowest basis id among the rows at the exact minimum ratio
        tie = theta == tmin
        bmin = torch.where(tie, s["basis"], INT_MAX).min()
        ib = torch.where(tie & (s["basis"] == bmin), rows, INT_MAX).min()
        pass2.append(kc.plain(((bmin.to(torch.int64) << 32) | ib.to(torch.int64)).view(1)))
    pass2 = kc.reduce(torch.cat(pass2), cx.rows, "ratio_rows")
    if bland:
        q = kc.plain_of(pass2[1]) & _LOW32
    elif harris:
        q = kc.index(pass2[0])
    else:
        q = kc.plain_of(pass2[0])
    q = torch.where(q == INT_MAX, 0, q)
    return q, theta, unbounded


def _step(cx: Ctx, s: dict, ctl: Control) -> dict:
    """One pivot of ``_solve_2d_local``'s body, or a terminal status.
    Updates ``s["B_inv"]`` (the rank-1 update, the flush) and the rows of
    ``s["U"]`` / ``s["R"]`` in place and returns the new state."""
    opts, dev, dtype = cx.opts, cx.device, cx.dtype
    eps = opts.resolve_eps()
    bland = _step_mod.bland_on(opts, ctl.degen)
    use_bland = _step_mod._const_flag(dev, bland)
    multi, defer = cx.K > 0, cx.L > 0
    npend = ctl.npend

    # ---- pricing and the ftran of the rank's rows ----
    if multi:
        min_exact = torch.full((), math.inf, dtype=dtype, device=dev)
        if ctl.need_refill:
            min_exact, s = _refill(cx, s, ctl, bland)
            npend = 0 if ctl.npend >= cx.L else npend
        s_now = torch.where(s["cvalid"], s["ce"], math.inf)
        j = torch.argmin(s_now).view(1)
        s_j = s_now.index_select(0, j).view(())
        min_e = torch.where(torch.isfinite(s_j), s_j, min_exact)
        p = s["cidx"].index_select(0, j).view(())
        A_p = s["cacols"].index_select(1, j).view(-1)
        c_p = s["ccost"].index_select(0, j).view(())
        e_p = torch.dot(s["y"], A_p) - c_p
        alpha = s["calpha"].index_select(1, j).view(-1) + s["U"].T @ (s["R"] @ A_p)
    else:
        p, min_e, col = _price(cx, s, ctl, bland, use_bland)
        A_p, c_p, e_p = col if col is not None else _entering(cx, s, p)
        alpha = torch.mv(s["B_inv"], A_p)
        if defer:
            # the true inverse's rows are B_inv + U.T R
            alpha = alpha + s["U"].T @ (s["R"] @ A_p)
    optimal = min_e >= -eps

    # ---- ratio test over "rows", then row q of the inverse from its owner ----
    q, theta, unbounded = _ratio_rows(cx, s, alpha, bland)
    own, ql = _own_rows(cx, q.view(1))
    parts = [s["B_inv"].index_select(0, ql).view(-1), alpha.index_select(0, ql), theta.index_select(0, ql)]
    if defer:
        parts.append(s["U"].index_select(1, ql).view(-1))
    buf = _rows_sum(cx, torch.where(own, torch.cat(parts), 0), "pivot_row")
    m = cx.m
    binv_q, alpha_q, theta_q = buf[:m], buf[m], buf[m + 1]
    if defer:
        # row q of the true inverse: the base row plus the pending pairs
        binv_q = binv_q + buf[m + 2 :] @ s["R"]
    theta_q = torch.where(unbounded, math.inf, theta_q)

    do_pivot = ~optimal & ~unbounded
    bad = ~torch.isfinite(min_e) | (do_pivot & ~torch.isfinite(theta_q))
    do_pivot = do_pivot & ~bad
    if multi:
        # the exact entry recheck at eps / 2 (a rejected skip counts toward
        # the degenerate streak)
        cand_fresh = e_p < -(eps * 0.5)
        do_pivot = do_pivot & (cand_fresh | use_bland)
    inv_aq = 1 / torch.where(do_pivot, alpha_q, 1)
    th = torch.where(do_pivot, theta_q, 0)

    # ---- the update of the rank's rows ----
    at_q = own & (torch.arange(cx.m_loc, device=dev) == ql)
    eta = torch.where(at_q, inv_aq - 1, -alpha * inv_aq)
    out = dict(s)
    if defer:
        s["U"][npend] = torch.where(do_pivot, eta, 0)
        s["R"][npend] = torch.where(do_pivot, binv_q, 0)
        out["npend"] = s["npend"] + do_pivot.to(torch.int32)
        if not multi and npend + 1 >= opts.update_defer:
            # the flush (on a step that does not pivot too: it is terminal,
            # and its zero pair leaves the true inverse as it was)
            s["B_inv"].addmm_(s["U"].T, s["R"])
            out["U"], out["R"] = torch.zeros_like(s["U"]), torch.zeros_like(s["R"])
            out["npend"] = torch.zeros_like(s["npend"])
    else:
        cx.backend.rank1_update(
            s["B_inv"], torch.where(do_pivot, eta, 0), torch.where(do_pivot, binv_q, 0)
        )
    x_new = torch.where(at_q, th, s["x_b"] - th * alpha)
    out.update(
        x_b=torch.where(do_pivot, x_new, s["x_b"]),
        y=torch.where(do_pivot, s["y"] - (e_p * inv_aq) * binv_q, s["y"]),
        c_b=torch.where(do_pivot & at_q, c_p, s["c_b"]),
        basis=torch.where(do_pivot & at_q, p, s["basis"]),
        iters=s["iters"] + do_pivot.to(torch.int32),
    )
    status = torch.where(
        optimal, int(SolveStatus.OPTIMAL),
        torch.where(unbounded, int(SolveStatus.UNBOUNDED),
                    torch.where(bad, int(SolveStatus.SINGULAR), _RUNNING)),
    ).to(torch.int32)
    out["status"] = status
    degen_new = torch.where(theta_q <= opts.degen_tol, s["degen"] + 1, torch.zeros_like(s["degen"]))
    degen_keep = s["degen"]
    if multi:
        degen_keep = torch.where(~cand_fresh & (status == _RUNNING), s["degen"] + 1, s["degen"])
        # exact update of every candidate's reduced cost from the true row q;
        # the entering one, and one that failed its recheck, drop out
        w_c = binv_q @ s["cacols"]
        drop = do_pivot | (~cand_fresh & ~optimal)
        out["ce"] = torch.where(do_pivot, s["ce"] - (e_p * inv_aq) * w_c, s["ce"])
        out["cvalid"] = torch.where(drop, s["cvalid"] & (s["cidx"] != p), s["cvalid"])
    out["degen"] = torch.where(do_pivot, degen_new, degen_keep)
    if opts.pricing == "devex":
        # the rank's reduced costs and reference weights: w = rho.A on its
        # columns, gamma_p from its owner
        w = cx.backend.pricing_update(cx.prob.A, binv_q * inv_aq)
        gamma_p = cx.backend.gather_cost(s["gamma"], p)
        gamma = torch.maximum(s["gamma"], (w * w) * gamma_p.clamp_min(1)).clamp(1.0, 1e30)
        out["e"] = torch.where(do_pivot, s["e"] - e_p * w, s["e"])
        out["gamma"] = torch.where(do_pivot, gamma, s["gamma"])
    return out


# ---- the distributed Newton-Schulz -----------------------------------------


def refactorize_2d(cx: Ctx, s: dict) -> dict:
    """``simplex_tpu/dist/sharded2d.py:731-858``: the rank's rows of the
    basis matrix (its columns summed from their owners over all ranks),
    then X <- X (2I - B X) over "rows" with the row blocks all-gathered,
    seeded by the drifted inverse (pending pairs folded in), or by the
    scaled transpose B^T / (||B||_1 ||B||_inf) when that seed does not
    contract. x_b, y (and devex's e, gamma = 1) are re-derived; the
    pending pairs and the candidate buffer are dropped."""
    dtype, dev = cx.dtype, cx.device
    m, m_loc, r0 = cx.m, cx.m_loc, cx.row_base
    B = cx.backend.gather_basis_matrix(cx.prob.A, basis_full(cx, s)).to(dtype)
    B_loc = B[r0 : r0 + m_loc]
    eye_loc = torch.zeros((m_loc, m), dtype=dtype, device=dev)
    eye_loc[torch.arange(m_loc, device=dev), r0 + torch.arange(m_loc, device=dev)] = 1

    def resid(Y_loc):
        return all_reduce((Y_loc - eye_loc).abs().max().view(1), dist.ReduceOp.MAX, cx.rows, "refactor")

    def bx(X_loc):
        X_full = _rows_gather(cx, X_loc, "refactor")
        return X_full, B_loc @ X_full

    X = s["B_inv"]
    if cx.L:
        X = torch.addmm(X, s["U"].T, s["R"])
    X_full, Y = bx(X)
    seed_resid = float(resid(Y))
    if not (math.isfinite(seed_resid) and seed_resid < 0.5):
        # the Pan-Schreiber start, from the whole basis matrix every rank holds
        absB = B.abs()
        scale = torch.clamp_min(absB.sum(0).max() * absB.sum(1).max(), torch.finfo(dtype).tiny)
        X = (B[:, r0 : r0 + m_loc].T / scale).contiguous()
        X_full, Y = bx(X)
        seed_resid = float(resid(Y))
    floor = 16 * torch.finfo(dtype).eps
    resid_v, prev, it = seed_resid, math.inf, 0
    while resid_v > floor and resid_v < prev and it < NS_MAX_ITER:
        # X (2I - B X), the product's (m, m) operand made in place
        T = _rows_gather(cx, Y, "refactor").neg_()
        T.diagonal().add_(2)
        X = X @ T
        del T
        X_full, Y = bx(X)
        prev, resid_v, it = resid_v, float(resid(Y)), it + 1
    c_b_full = _rows_gather(cx, s["c_b"], "refactor")
    out = dict(s)
    out.update(
        B_inv=X.contiguous(), x_b=X @ cx.prob.b, y=c_b_full @ X_full, last_refac=s["iters"].clone(),
    )
    if cx.L:
        out["U"], out["R"] = torch.zeros_like(s["U"]), torch.zeros_like(s["R"])
        out["npend"] = torch.zeros_like(s["npend"])
    if cx.K:
        # the buffered columns were ftran'd against the old inverse
        out["cvalid"] = torch.zeros_like(s["cvalid"])
    if cx.opts.pricing == "devex":
        out["e"] = _ops.pricing_update(cx.prob.A, out["y"]) - cx.prob.c
        out["gamma"] = torch.ones_like(s["gamma"])
    return out


# ---- the loop and its entries ------------------------------------------------


def _loop(cx: Ctx, s: dict, ctl: Control, max_iter: int):
    while ctl.status == _RUNNING and ctl.iters < max_iter:
        s = _step(cx, s, ctl)
        ctl = read_control(cx, s)
        every = cx.opts.refactor_every
        if every > 0 and ctl.status == _RUNNING and ctl.iters > 0 and ctl.iters % every == 0:
            s = refactorize_2d(cx, s)
            ctl = read_control(cx, s)
    return s, ctl


def run(cx: Ctx, s: dict, max_iter: int) -> dict:
    """The pivot loop from ``s`` until a terminal status or ``max_iter``
    pivots, then up to four verify rounds (each a re-inversion and the
    loop again) while the terminal decision came from a drifted inverse;
    a still-running status becomes MAX_ITER (``simplex_tpu/dist/
    sharded2d.py:897-931``)."""
    ctl = read_control(cx, s)
    s, ctl = _loop(cx, s, ctl, max_iter)
    rounds = 0
    while (
        cx.opts.verify_terminal and rounds < MAX_VERIFY_ROUNDS and ctl.status != _RUNNING
        and ctl.iters < max_iter and ctl.iters > ctl.last_refac
    ):
        s = refactorize_2d(cx, s)
        s["status"] = torch.full_like(s["status"], _RUNNING)
        s, ctl = _loop(cx, s, read_control(cx, s), max_iter)
        rounds += 1
    if ctl.status == _RUNNING:
        s["status"] = torch.full_like(s["status"], int(SolveStatus.MAX_ITER))
    return s


def _i32(v, dev) -> torch.Tensor:
    return torch.tensor(int(v), dtype=torch.int32, device=dev)


def start_state(cx: Ctx, basis0: np.ndarray, iters0: int = 0, degen0: int = 0) -> dict:
    """The state at a basis whose columns form the identity (B_inv rows of
    I, x_b = b, y = c_b), the costs of the slots summed from their column
    owners; with the counters of a snapshot when resuming."""
    dev, dtype, m, m_loc, r0 = cx.device, cx.dtype, cx.m, cx.m_loc, cx.row_base
    basis = torch.as_tensor(np.asarray(basis0, np.int32), device=dev)
    c_b = cx.backend.gather_costs(cx.prob.c, basis).to(dtype)  # (m,), replicated
    eye_loc = torch.zeros((m_loc, m), dtype=dtype, device=dev)
    eye_loc[torch.arange(m_loc, device=dev), r0 + torch.arange(m_loc, device=dev)] = 1
    s = {
        "last_refac": _i32(iters0, dev), "B_inv": eye_loc, "x_b": cx.prob.b[r0 : r0 + m_loc].clone(),
        "y": c_b.clone(), "c_b": c_b[r0 : r0 + m_loc].clone(), "basis": basis[r0 : r0 + m_loc].clone(),
        "iters": _i32(iters0, dev), "status": _i32(_RUNNING, dev), "degen": _i32(degen0, dev),
    }
    if cx.L:
        s.update(
            U=torch.zeros((cx.L, m_loc), dtype=dtype, device=dev),
            R=torch.zeros((cx.L, m), dtype=dtype, device=dev), npend=_i32(0, dev),
        )
    if cx.K:
        K = cx.K
        s.update(
            cidx=torch.zeros(K, dtype=torch.int32, device=dev), ce=torch.zeros(K, dtype=dtype, device=dev),
            cvalid=torch.zeros(K, dtype=torch.bool, device=dev), ce0=torch.zeros((), dtype=dtype, device=dev),
            cacols=torch.zeros((m, K), dtype=dtype, device=dev), ccost=torch.zeros(K, dtype=dtype, device=dev),
            calpha=torch.zeros((m_loc, K), dtype=dtype, device=dev),
        )
    if cx.opts.pricing == "devex":
        s["e"] = _ops.pricing_update(cx.prob.A, s["y"]) - cx.prob.c
        s["gamma"] = torch.ones(cx.hi - cx.lo, dtype=dtype, device=dev)
    return s


def start(cx: Ctx, basis0: np.ndarray, max_iter: int) -> dict:
    """The fresh start from ``basis0`` (A[:, basis0] = I)."""
    return run(cx, start_state(cx, basis0), max_iter)


def resume(cx: Ctx, basis: np.ndarray, iters0: int, degen0: int, max_iter: int) -> dict:
    """The resume from a light snapshot's basis and counters: the state
    rebuilt on the mesh by :func:`refactorize_2d` (any basis), then the
    loop."""
    return run(cx, refactorize_2d(cx, start_state(cx, basis, iters0, degen0)), max_iter)


def cont(cx: Ctx, state: dict, max_iter: int) -> dict:
    """The continuation of a chunk's state as it is (no rebuild)."""
    return run(cx, state, max_iter)


# the leaves of a 2-D state, with the axis split over "rows" (0: rows of a
# vector or matrix, 1: columns of U) or over the flattened mesh ("cols")
_ROW_LEAVES = {"B_inv": 0, "x_b": 0, "c_b": 0, "basis": 0, "U": 1, "calpha": 0}
_COL_LEAVES = ("e", "gamma")
_INT_LEAVES = ("last_refac", "iters", "status", "degen", "npend", "cidx", "basis")


def state_2d_from_numpy(leaves: Mapping[str, object], cx: Ctx) -> dict:
    """This rank's shards of a global 2-D state with the reference's keys
    (``simplex_tpu/dist/sharded2d.py:999-1029``; B_inv (m, m), x_b, c_b,
    basis (m,), U (L, m), calpha (m, K), e / gamma (n,) and the replicated
    leaves), so that both packages can run a chunk from one state."""
    dev, r0, r1 = cx.device, cx.row_base, cx.row_base + cx.m_loc
    out = {}
    for k, v in leaves.items():
        v = np.asarray(v)
        if k in _ROW_LEAVES:
            v = v[r0:r1] if _ROW_LEAVES[k] == 0 else v[:, r0:r1]
        elif k in _COL_LEAVES:
            v = v[cx.lo : cx.hi]
        t = torch.as_tensor(np.array(v), device=dev)  # a copy, 0-d kept 0-d
        if k in _INT_LEAVES:
            t = t.to(torch.int32)
        elif k != "cvalid":
            t = t.to(cx.dtype)
        out[k] = t
    return out


def make_context(A, b, c, mesh, options: SimplexOptions, device=None) -> Ctx:
    """Check the options and shapes and move this rank's shards to
    ``device``. Every rank of ``mesh`` calls it with the same arguments."""
    if options.pricing == "steepest":
        raise NotImplementedError(
            "pricing='steepest' is single-chip only (its weight scatter "
            "needs global column addressing); use devex for sharded solves"
        )
    if options.multi_price > 0 and options.pricing != "dantzig":
        get_logger("dist2d").warning(
            "multi_price=%d is inert under pricing=%r (dantzig only); "
            "solving without multiple pricing", options.multi_price, options.pricing,
        )
        options = dataclasses.replace(options, multi_price=0)
    options = check_supported(options)
    mesh = require_mesh(mesh)
    if tuple(mesh.mesh_dim_names or ()) != (ROWS_AXIS, COLS_AXIS):
        raise ValueError(f"mesh axes must be {(ROWS_AXIS, COLS_AXIS)}, got {mesh.mesh_dim_names}")
    R, C = (int(v) for v in mesh.mesh.shape)
    b, c = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in (b, c))
    if not isinstance(A, torch.Tensor) and not _sp.is_sparse(A) and not hasattr(A, "shape"):
        A = np.asarray(A)
    m, n = A.shape
    if m > n:
        raise ValueError(f"m > n ({m} > {n}): not a canonical-form LP")
    if b.shape != (m,) or c.shape != (n,):
        raise ValueError(f"shape mismatch: A {A.shape}, b {b.shape}, c {c.shape}")
    _check_2d_shapes((m, n), R, C)
    r_ix, c_ix = (int(v) for v in mesh.get_coordinate())
    slot = r_ix * C + c_ix
    bounds = shard_bounds(n, R * C)
    lo, hi = int(bounds[slot]), int(bounds[slot + 1])
    sparse = _sp.is_sparse(A)
    S = options.partial_pricing
    widths = np.diff(bounds)
    active = {
        options.pricing == "dantzig" and not sparse and S > 1 and int(w) % S == 0
        and int(w) // S >= options.partial_min_segment
        for w in widths
    }
    if len(active) > 1:
        raise ValueError(
            f"partial_pricing={S}: shards of {sorted(set(widths.tolist()))} columns disagree on "
            "segmented pricing; pick n or partial_pricing so that they agree"
        )
    device = default_device(mesh, device)
    pin_full_fp32()
    dtype = options.dtype
    prob = Problem(
        A=_local_columns(A, lo, hi, dtype, device),
        b=torch.as_tensor(b, device=device).to(dtype).contiguous(),
        c=torch.as_tensor(c[lo:hi], device=device).to(dtype).contiguous(),
    )
    prob = with_pricing_shadow(prob, options.pricing_dtype, options.pricing)
    rows = mesh.get_group(ROWS_AXIS)
    grid = mesh.mesh
    rows_order = [int((grid == g).nonzero()[0, 0]) for g in dist.get_process_group_ranks(rows)]
    multi = options.multi_price > 0 and options.pricing == "dantzig"
    defer = options.update_defer > 0 or multi
    everyone = flat_group(mesh)
    return Ctx(
        opts=options, m=m, n=n, R=R, C=C, r_ix=r_ix, lo=lo, hi=hi, prob=prob, rows=rows,
        everyone=everyone, rows_order=rows_order, slot=slot,
        backend=make_collective_backend(everyone, lo, hi - lo, n=n, kernels=options.backend, dtype=dtype),
        keys=key_codec(dtype),
        partial=active.pop(),
        K=min(options.multi_price, n // (R * C)) if multi else 0,
        L=max(options.resolve_defer(), 1) if defer else 0,
    )


def result(cx: Ctx, s: dict, b, c) -> SolveResult:
    """``finalize_result`` on the whole basis: x_b, c_b and the basis ids
    gathered over "rows" (one SUM), the basis columns summed from their
    owners, and the f64 refinement preconditioned by the ROW-SHARDED
    inverse (each pass one product of the rank's rows, the pending pairs
    folded in, and one gather over "rows"): B_inv is never gathered whole,
    which would cost m^2 floats on every rank (4 GiB at m = 32,768)."""
    m, m_loc, r0, dev = cx.m, cx.m_loc, cx.row_base, cx.device
    buf = torch.zeros((3, m), dtype=torch.float64, device=dev)
    buf[0, r0 : r0 + m_loc] = s["x_b"].double()
    buf[1, r0 : r0 + m_loc] = s["c_b"].double()
    buf[2, r0 : r0 + m_loc] = s["basis"].double()
    buf = _rows_sum(cx, buf, "result_rows")
    B_loc, U, R = s["B_inv"], s.get("U"), s.get("R")
    if U is not None:
        B_loc = torch.addmm(B_loc, U.T, R)

    def precondition(r: torch.Tensor) -> torch.Tensor:
        return _rows_gather(cx, B_loc @ r.to(B_loc.dtype), "result_rows").double()

    final = SolverState(
        B_inv=B_loc, x_b=buf[0].to(cx.dtype), y=s["y"], c_b=buf[1].to(cx.dtype),
        basis=buf[2].to(torch.int32), iters=s["iters"], status=s["status"], degen=s["degen"],
        last_refac=s["last_refac"],
    )
    return finalize_result(
        cx.prob, b, c, final, cx.opts, basis_columns=cx.backend.basis_columns64, precondition=precondition,
    )


def solve_sharded_2d(
    A,
    b,
    c,
    mesh,
    *,
    basis0=None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    device=None,
) -> SolveResult:
    """Solve  max c.x  s.t.  A x = b, x >= 0  on a 2-D mesh: A's columns over
    all ranks, B_inv's rows over "rows" (``mesh`` from
    :func:`~simplex_tpu_torch.dist.mesh.make_mesh` with axes ``("rows",
    "cols")``). Every rank calls it with the same arguments and returns the
    same result.

    ``A`` is the full matrix on every rank (numpy, a memmap, a tensor, or
    sparse: scipy.sparse, a sparse tensor or a :class:`~simplex_tpu_torch.sparse.SparseA`),
    of which each rank moves only its own columns to ``device`` (default:
    the mesh's device type, on the current card). m must divide by R;
    columns may split unevenly. ``basis0`` (default: the trailing slack
    block) must satisfy A[:, basis0] = I. ``pricing="steepest"`` raises;
    ``multi_price`` under devex warns and is inert; ``perturb_after`` and
    ``recompute_every`` are not part of this mode (as in the reference).

    The result is polished in float64 as the single solve's is (when m <=
    ``polish_max_m``): the basis columns are summed from their owners, and
    the iterative refinement is preconditioned by the row-sharded inverse
    itself, one row-block product and one gather over "rows" a pass, as
    the reference's refinement runs against its row-sharded inverse;
    B_inv is never gathered whole (m^2 floats a rank, 4 GiB at m =
    32,768)."""
    cx = make_context(A, b, c, mesh, options, device)
    m, n = cx.m, cx.n
    basis0 = np.arange(n - m, n) if basis0 is None else np.asarray(basis0)
    final = start(cx, basis0, cx.opts.resolve_max_iter(m, n))
    return result(cx, final, np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b),
                  np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c))
