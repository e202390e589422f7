"""Problem and solver state.

Mutable dataclasses of tensors in place of the JAX package's NamedTuple
pytrees. Leaves for an m x n problem:

  B_inv      (m, m)  explicit basis inverse, product-form maintained
  x_b        (m,)    basic values (B x_b = b)
  y          (m,)    simplex multipliers (y = c_b B_inv)
  c_b        (m,)    costs of the basic columns
  basis      (m,)    column index of each basic variable (int32)
  iters      ()      pivots taken (int32)
  status     ()      SolveStatus code (int32)
  degen      ()      consecutive degenerate pivots (int32)
  last_refac ()      pivot count at the last exact inverse (int32)
  U, R       (L, m)  pending (eta, true-inverse row) pairs of the deferred
                     update; the true inverse is B_inv + U.T @ R
  npend      ()      number of pending pairs (int32)
  e          (n,)    devex / steepest edge: the reduced costs y.A - c,
                     maintained incrementally (never sign-flipped)
  gamma      (n,)    devex reference weights, or steepest edge's exact
                     norms 1 + |B_inv A_j|^2
  at_upper   (n,)    bounded problems: nonbasic columns parked at their
                     upper bound (never set on a basic column), so
                     x_N = where(at_upper, u, 0) and B x_b = b - A x_N
  cand               the multiple-pricing candidate buffer
  pert               the rhs perturbation
  carried            the next default step's entering pick, made by the
                     step that returned the state (``core.step``)

U, R and npend are None when updates are eager, e and gamma under the
Dantzig rule, at_upper when the problem has no upper bounds, cand when
multiple pricing is off, pert when the perturbation is off (the JAX package
carries dummy leaves there instead).

``carried`` is None except on a state the default step returned, and
holds for that state alone: every upkeep, and the solve loop on its way
out, drops it.

Scalars stay 0-d device tensors so a pivot step never waits on the host.
The pivot step updates ``B_inv`` (the rank-1 update, the rank-L flush) and
the rows of ``U`` / ``R`` in place; every other leaf of the state it
returns is a new tensor.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.status import SolveStatus


@dataclasses.dataclass
class Problem:
    """A canonical-form LP: maximize c.x  s.t.  A x = b, 0 <= x (<= u).

    ``A_price`` is the optional bfloat16 shadow of A that pricing reads in
    place of A; every candidate it yields is rechecked against A. ``u``
    (optional, +inf where a column has no bound) selects the
    bounded-variable rule: nonbasic columns sit at 0 or at u, the ratio
    test is two-sided and a step may flip a column between its bounds.

    ``A`` may be a :class:`~simplex_tpu_torch.sparse.SparseA` (the sparse
    solve: every op that reads A dispatches on it; no shadow), and
    ``A_segs`` holds the column segments segmented pricing scans (a column
    range of a compressed matrix is not a view; None = segmented pricing
    off). ``pricing_sparse`` makes ``A_price`` a sparse copy of a dense A."""

    A: torch.Tensor  # (m, n), or a SparseA
    b: torch.Tensor  # (m,)
    c: torch.Tensor  # (n,)
    A_price: Optional[torch.Tensor] = None  # (m, n) bfloat16, or a SparseA
    u: Optional[torch.Tensor] = None  # (n,) upper bounds, +inf = none
    A_segs: Optional[tuple] = None  # sparse A: SparseA column segments


def with_pricing_shadow(
    prob: Problem, pricing_dtype: str, pricing: str = "dantzig"
) -> Problem:
    """Attach the reduced-precision pricing shadow of A when requested (one
    cast pass at solve start; ``"float32"``, devex and steepest edge leave
    the problem as it is). A sparse A takes none: its SpMV reads float32
    values and indices whatever the values were rounded to, so a shadow
    would cost a copy and the recheck and save no byte."""
    if pricing_dtype == "float32" or pricing in ("devex", "steepest") or isinstance(prob.A, _sp.SparseA):
        return prob
    shadow = prob.A.to(getattr(torch, pricing_dtype)).contiguous()
    return dataclasses.replace(prob, A_price=shadow)


@dataclasses.dataclass
class PertState:
    """The anti-degeneracy rhs shift: x_b solves B x_b = b + w exactly while
    ``on``; ``rounds`` counts activations."""

    w: torch.Tensor  # (m,)
    on: torch.Tensor  # () bool
    rounds: torch.Tensor  # () int32


@dataclasses.dataclass
class CandBuffer:
    """The multiple-pricing candidate buffer, frozen-base form (see
    ``simplex_tpu.core.state.CandBuffer``): ``alpha[j]`` is candidate j's
    ftran against the base inverse at refill time, never updated; the
    current column is ``alpha[j] + U.T (R A_j)``. ``e`` is updated exactly
    each pivot from the cached columns ``acols``; ``valid`` clears when a
    candidate enters, fails its exact recheck, or the inverse is rebuilt."""

    idx: torch.Tensor  # (K,) int32 column indices
    alpha: torch.Tensor  # (K, m) refill-time base ftrans
    acols: torch.Tensor  # (K, m) gathered A columns
    e: torch.Tensor  # (K,) reduced costs
    valid: torch.Tensor  # (K,) bool
    e0: torch.Tensor  # () refill-time best improvement (<= 0)
    seg: torch.Tensor  # () int32 refill counter (segment rotation)


class CarriedPick(NamedTuple):
    """The entering pick of the step from a state, made by the default step
    that returned the state: its pricing (Bland's rule off), the column's
    exact reduced cost and cost, and its ftran, fused into that step's
    rank-1 update (``core.step``)."""

    p: torch.Tensor  # () int32 entering column
    min_e: torch.Tensor  # () pricing's minimum
    e_p: torch.Tensor  # () exact reduced cost y.A_p - c_p
    c_p: torch.Tensor  # () c[p]
    alpha: torch.Tensor  # (m,) B_inv A_p


@dataclasses.dataclass
class SolverState:
    B_inv: torch.Tensor
    x_b: torch.Tensor
    y: torch.Tensor
    c_b: torch.Tensor
    basis: torch.Tensor
    iters: torch.Tensor
    status: torch.Tensor
    degen: torch.Tensor
    last_refac: torch.Tensor
    U: Optional[torch.Tensor] = None
    R: Optional[torch.Tensor] = None
    npend: Optional[torch.Tensor] = None
    at_upper: Optional[torch.Tensor] = None
    cand: Optional[CandBuffer] = None
    pert: Optional[PertState] = None
    e: Optional[torch.Tensor] = None
    gamma: Optional[torch.Tensor] = None
    carried: Optional[CarriedPick] = None


def _int(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.int32, device=device)


def _pert_extras(m: int, dtype, device, perturb: bool) -> Optional[PertState]:
    if not perturb:
        return None
    return PertState(
        w=torch.zeros(m, dtype=dtype, device=device),
        on=torch.zeros((), dtype=torch.bool, device=device),
        rounds=_int(0, device),
    )


def steepest_gamma(prob: Problem, B_inv: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """Exact steepest-edge weights gamma_j = 1 + |B_inv A_j|^2: one
    (m, m) x (m, n) product in full fp32 (the column norms of A when
    ``B_inv`` is None, the identity slack basis). Sparse A: the column
    sums of squares, or dense column chunks through one GEMM each."""
    if isinstance(prob.A, _sp.SparseA):
        A = prob.A.to(dtype=dtype)
        if B_inv is None:
            return (1 + _sp.col_sumsq(A)).to(dtype)
        return _steepest_gamma_sparse(B_inv, A, dtype)
    A = prob.A.to(dtype)
    T = A if B_inv is None else B_inv @ A
    return 1 + (T * T).sum(0)


def _steepest_gamma_sparse(B_inv, A, dtype, chunk: int = 512) -> torch.Tensor:
    """gamma_j = 1 + |B_inv A_j|^2 for a sparse A
    (``simplex_tpu.core.state._steepest_gamma_sparse``): ``chunk`` columns
    at a time gathered dense and pushed through one (m, m) x (m, chunk)
    product, so the extra memory is m * chunk, not m * n."""
    n = A.shape[1]
    out = []
    for lo in range(0, n, chunk):
        ids = torch.arange(lo, min(lo + chunk, n), device=B_inv.device)
        T = B_inv @ _sp.gather_columns(A, ids).to(dtype)
        out.append((T * T).sum(0))
    return 1 + torch.cat(out)


def _pricing_extras(prob: Problem, y: torch.Tensor, dtype, pricing: str, B_inv=None) -> dict:
    """(e, gamma) for the devex / steepest-edge rules
    (``simplex_tpu.core.state._pricing_extras``): e = y.A - c; devex starts
    from unit reference weights, steepest edge from the true norms. Empty
    under the Dantzig rule."""
    if pricing not in ("devex", "steepest"):
        return {}
    e = _ops.reduced_costs(y, prob.A, prob.c.to(dtype))
    if pricing == "steepest":
        gamma = steepest_gamma(prob, B_inv, dtype)
    else:
        gamma = torch.ones(prob.A.shape[1], dtype=dtype, device=prob.A.device)
    return {"e": e, "gamma": gamma}


def _defer_extras(m: int, dtype, device, update_defer: int) -> dict:
    """Zeroed (U, R, npend) for L = update_defer pending pairs; None when
    updates are eager."""
    if update_defer <= 0:
        return {}
    return {
        "U": torch.zeros((update_defer, m), dtype=dtype, device=device),
        "R": torch.zeros((update_defer, m), dtype=dtype, device=device),
        "npend": _int(0, device),
    }


def _cand_extras(m: int, n: int, dtype, device, multi_price: int) -> Optional[CandBuffer]:
    """An empty candidate buffer of K = min(multi_price, n) slots; None when
    multiple pricing is off."""
    if multi_price <= 0:
        return None
    K = min(multi_price, n)
    return CandBuffer(
        idx=torch.zeros(K, dtype=torch.int32, device=device),
        alpha=torch.zeros((K, m), dtype=dtype, device=device),
        acols=torch.zeros((K, m), dtype=dtype, device=device),
        e=torch.zeros(K, dtype=dtype, device=device),
        valid=torch.zeros(K, dtype=torch.bool, device=device),
        e0=torch.zeros((), dtype=dtype, device=device),
        seg=_int(0, device),
    )


def _at_upper_extras(prob: Problem, at_upper0) -> Optional[torch.Tensor]:
    """(n,) nonbasic-at-upper flags when the problem is bounded (all False
    unless ``at_upper0`` says otherwise); None otherwise."""
    if prob.u is None:
        return None
    n = prob.A.shape[1]
    if at_upper0 is None:
        return torch.zeros(n, dtype=torch.bool, device=prob.A.device)
    return torch.as_tensor(np.asarray(at_upper0, bool), device=prob.A.device)


def nonbasic_upper_values(prob: Problem, at_upper: torch.Tensor, dtype) -> torch.Tensor:
    """x_N as a full (n,) vector: u at the nonbasic-at-upper columns, 0
    elsewhere (``where``, never a product, so an infinite u meets no 0)."""
    return torch.where(at_upper, prob.u, 0).to(dtype)


def bounded_rhs(prob: Problem, at_upper: Optional[torch.Tensor], dtype) -> torch.Tensor:
    """b - A x_N, the rhs the basic variables solve against (b when the
    problem has no upper bounds)."""
    b = prob.b.to(dtype)
    if prob.u is None:
        return b
    return b - _ops.matvec(prob.A, nonbasic_upper_values(prob, at_upper, dtype))


def initial_state_slack(
    prob: Problem,
    dtype,
    perturb: bool = False,
    update_defer: int = 0,
    multi_price: int = 0,
    at_upper0=None,
    pricing: str = "dantzig",
) -> SolverState:
    """The trailing-identity slack basis: B_inv = I, x_b = b (b - A x_N
    when bounded), y = c_b = c[n-m:], basis = [n-m, ..., n-1].
    ``update_defer`` is the number of pending-pair rows
    (``SimplexOptions.resolve_defer()``); ``at_upper0`` marks the nonbasic
    columns that start at their upper bound; ``pricing`` adds the devex /
    steepest-edge leaves."""
    m, n = prob.A.shape
    dev = prob.A.device
    c_b = prob.c[n - m :].to(dtype).clone()
    at_upper = _at_upper_extras(prob, at_upper0)
    return SolverState(
        B_inv=torch.eye(m, dtype=dtype, device=dev),
        x_b=bounded_rhs(prob, at_upper, dtype).clone(),
        y=c_b.clone(),
        c_b=c_b,
        basis=torch.arange(n - m, n, dtype=torch.int32, device=dev),
        iters=_int(0, dev),
        status=_int(SolveStatus.RUNNING, dev),
        degen=_int(0, dev),
        last_refac=_int(0, dev),
        **_defer_extras(m, dtype, dev, update_defer),
        at_upper=at_upper,
        cand=_cand_extras(m, n, dtype, dev, multi_price),
        pert=_pert_extras(m, dtype, dev, perturb),
        **_pricing_extras(prob, c_b, dtype, pricing),
    )


def initial_state(
    prob: Problem,
    basis0,
    dtype,
    perturb: bool = False,
    update_defer: int = 0,
    multi_price: int = 0,
    at_upper0=None,
    pricing: str = "dantzig",
) -> SolverState:
    """Starting state for a given feasible basis: B_inv by one dense solve
    (an O(m^3) set-up cost), x_b = B_inv b (B_inv (b - A x_N) when
    bounded), y = c_b B_inv; under steepest edge also one (m, m) x (m, n)
    product for the exact weights."""
    m, n = prob.A.shape
    dev = prob.A.device
    basis = torch.as_tensor(np.asarray(basis0), dtype=torch.int32, device=dev)
    B = _ops.gather_basis_matrix(prob.A, basis).to(dtype)
    B_inv = torch.linalg.solve(B, torch.eye(m, dtype=dtype, device=dev)).contiguous()
    c_b = prob.c.index_select(0, basis).to(dtype)
    at_upper = _at_upper_extras(prob, at_upper0)
    y = c_b @ B_inv
    return SolverState(
        B_inv=B_inv,
        x_b=B_inv @ bounded_rhs(prob, at_upper, dtype),
        y=y,
        c_b=c_b,
        basis=basis,
        iters=_int(0, dev),
        status=_int(SolveStatus.RUNNING, dev),
        degen=_int(0, dev),
        last_refac=_int(0, dev),
        **_defer_extras(m, dtype, dev, update_defer),
        at_upper=at_upper,
        cand=_cand_extras(m, n, dtype, dev, multi_price),
        pert=_pert_extras(m, dtype, dev, perturb),
        **_pricing_extras(prob, y, dtype, pricing, B_inv=B_inv),
    )


def problem_from_numpy(A, b, c, device, dtype=torch.float32, u=None) -> Problem:
    """A Problem on ``device`` from host arrays (or tensors), cast to
    ``dtype``; ``u`` (optional) the upper bounds. A scipy.sparse ``A`` or a
    :class:`~simplex_tpu_torch.sparse.SparseA` stays sparse."""

    def put(v):
        return torch.as_tensor(v, device=device).to(dtype).contiguous()

    A = _sp.as_sparse(A, dtype, device) if _sp.is_sparse(A) else put(A)
    return Problem(A=A, b=put(b), c=put(c), u=None if u is None else put(u))


_LEAVES = ("B_inv", "x_b", "y", "c_b", "basis")
_SCALARS = ("iters", "status", "degen", "last_refac")


def state_from_numpy(leaves: Mapping[str, object], device) -> SolverState:
    """The port's state from host arrays, such as a ``simplex_tpu`` solver
    state's leaves (``{f: np.asarray(getattr(s, f))}``), so both packages
    can start from one mid-solve state.

    ``leaves["U"]``, ``["R"]`` and ``["npend"]`` (optional) are the
    deferred-update buffers; ``leaves["at_upper"]`` (optional) the
    bounded rule's flags; ``leaves["cand"]`` (optional) is None or the
    candidate buffer's (idx, alpha, acols, e, valid, e0, seg) in
    ``CandBuffer`` order; ``leaves["pert"]`` is None or the (w, on, rounds)
    triple; ``leaves["e"]`` and ``["gamma"]`` (optional) the devex /
    steepest-edge reduced costs and weights. The JAX package carries (1,)
    dummies for e and gamma under the Dantzig rule and (1, 1) dummies for U
    and R when ``update_defer`` is 0: pass those leaves only when the state
    has real ones.
    """

    def put(v, dtype=None):
        t = torch.as_tensor(np.array(v), device=device)
        return t.contiguous() if dtype is None else t.to(dtype)

    def scalar(v, dtype=torch.int32):
        return put(v, dtype).reshape(())

    st = {f: put(leaves[f]) for f in _LEAVES}
    st["basis"] = st["basis"].to(torch.int32)
    st.update({f: scalar(leaves[f]) for f in _SCALARS})
    if leaves.get("U") is not None:
        st.update(U=put(leaves["U"]), R=put(leaves["R"]), npend=scalar(leaves["npend"]))
    if leaves.get("at_upper") is not None:
        st["at_upper"] = put(leaves["at_upper"], torch.bool)
    cand = leaves.get("cand")
    if cand is not None:
        idx, alpha, acols, e, valid, e0, seg = cand
        st["cand"] = CandBuffer(
            idx=put(idx, torch.int32),
            alpha=put(alpha),
            acols=put(acols),
            e=put(e),
            valid=put(valid, torch.bool),
            e0=put(e0).reshape(()),
            seg=scalar(seg),
        )
    if leaves.get("e") is not None:
        st.update(e=put(leaves["e"]), gamma=put(leaves["gamma"]))
    pert = leaves.get("pert")
    if pert is not None:
        w, on, rounds = pert
        st["pert"] = PertState(
            w=put(w), on=scalar(on, torch.bool), rounds=scalar(rounds)
        )
    return SolverState(**st)
