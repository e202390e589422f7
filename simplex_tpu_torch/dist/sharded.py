"""Column-sharded solve over a mesh of ranks (``torch.distributed``).

The counterpart of ``simplex_tpu.dist.sharded``: the columns of A (and c)
are split over the ranks of one mesh axis, so the O(mn) pricing pass runs
on each rank's own columns, while B_inv, x_b, y, c_b, the basis and the
deferred pairs U / R are replicated (the O(m^2) update is repeated on
every rank and needs no communication). Under devex the reduced costs e
and the weights gamma are shard-local, as in the reference.

The distributed solve is the single solve's ``solve_state`` / ``pivot_step``
run on every rank with a collective backend: its ops are the only place
that communicates, and every rank calls them in the same order with the
same replicated arguments, so every branch the host takes (one control
read a pivot, the step's counted flag reads) reads replicated values.

  choose_entering     the rank's pricing pass over its shard
                      (``pricing_scan``: mask, min, lowest argmin and first
                      index below -eps), then ONE MIN over the ranks of two
                      keys: (order-preserving bits of min e, global index)
                      for Dantzig, the first global index below -eps for
                      Bland's rule
  gather_column_cost  ONE all-reduce SUM of the entering column with its
                      cost appended, zero on every rank but the owner
  devex_choose        ONE MIN of three keys (the score's argmax, Bland's
                      candidate, min e)
  gather_cost         an owner-masked SUM (devex's gamma_p)
  gather_basis_matrix an owner-masked SUM of the basis columns
                      (refactorization)
  the rest            ``pivot_tail`` / ``ratio_eta`` / ``rank1_update`` and
                      the shard-local ``pricing_update``: the single
                      solve's ops, kernels on the hopper backend

So a Dantzig pivot takes two collectives. A MIN's keys are of the working
dtype (:func:`key_codec`): in float32 one int64 a key (the value's 32
order bits above the index) and one all-reduce MIN; in float64 an int64
pair (the value's 64 order bits, the index) a key and one all-gather, then
the same lexicographic minimum on every rank, so that the value compared is
the float64 minimum itself. Ties break to the lowest global index, as in
the single solve and the reference. The pricing pass chunks
its rows as the pass over all n columns does, so each column's reduced
cost is bit for bit the single solve's and, on the default path, the
sharded solve follows the single solve pivot for pivot.

Shards may be uneven (``torch.tensor_split``: the first n mod R ranks hold
one column more), where the reference asks for padded columns.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import types
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.config import (
    DEFAULT_OPTIONS,
    SimplexOptions,
    check_supported,
    pin_full_fp32,
)
from simplex_tpu_torch.core.solver import SolveResult, finalize_result, solve_state
from simplex_tpu_torch.core.state import (
    Problem,
    SolverState,
    _defer_extras,
    _int,
    _pricing_extras,
    with_pricing_shadow,
)
from simplex_tpu_torch.dist.mesh import COLS_AXIS, require_mesh
from simplex_tpu_torch.kernels import hopper as _hopper
from simplex_tpu_torch.kernels import ops as _ops
from simplex_tpu_torch.kernels.dispatch import get_backend
from simplex_tpu_torch.logging import get_logger
from simplex_tpu_torch.status import SolveStatus

# collectives issued by the distributed modes since the last
# reset_collectives(), by the name each mode gives its op (here "init": the
# start state's c_b); an op not issued reads 0
collectives: collections.Counter = collections.Counter()


def reset_collectives() -> None:
    collectives.clear()


def all_reduce(t: torch.Tensor, op, group, name: str) -> torch.Tensor:
    """``dist.all_reduce`` of ``t`` in place over ``group``, counted under
    ``name``; returns ``t``. ``t`` must be a tensor of its own, never a view
    of a leaf the solve keeps (B_inv, U, R)."""
    collectives[name] += 1
    dist.all_reduce(t, op=op, group=group)
    return t


# one all-gather into one buffer (all_gather_single where this torch has
# it, all_gather_into_tensor, its older name, elsewhere)
_gather_into = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather(t: torch.Tensor, group, name: str) -> torch.Tensor:
    """Every rank's ``t`` over ``group``, stacked in group-rank order as
    (world, *t.shape), through ONE all-gather into one buffer; counted
    under ``name``."""
    collectives[name] += 1
    world = dist.get_world_size(group)
    out = t.new_empty((world * t.numel(),))
    _gather_into(out, t.contiguous().reshape(-1), group=group)
    return out.view(world, *t.shape)


def default_device(mesh, device=None) -> torch.device:
    """``device``, or the mesh's device type on the current card."""
    if device is None:
        device = torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda" else "cpu"
    return torch.device(device)


_NONE = 1 << 62  # the first-index key of "no candidate": above every column index
_LOW32 = 0xFFFFFFFF
_LOW63 = (1 << 63) - 1


def _order_bits(v: torch.Tensor) -> torch.Tensor:
    """float32 values as int64 keys that sort as the values do: -0.0 as
    +0.0, and NaN first (as the pricing kernel's min and torch.min take
    it)."""
    v = torch.where(v == 0, 0.0, v.to(torch.float32)).contiguous()
    bits = v.view(torch.int32)
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.where(torch.isnan(v), -(2**31), key).to(torch.int64)


def _order_bits64(v: torch.Tensor) -> torch.Tensor:
    """float64 values as int64 keys that sort as the values do (all 64
    bits: the same sign flip as :func:`_order_bits`, -0.0 as +0.0, NaN
    first)."""
    v = torch.where(v == 0, 0.0, v.to(torch.float64)).contiguous()
    bits = v.view(torch.int64)
    key = torch.where(bits < 0, bits ^ _LOW63, bits)
    return torch.where(torch.isnan(v), -(2**63), key)


def _from_order_bits64(key: torch.Tensor) -> torch.Tensor:
    """The float64 value of an :func:`_order_bits64` key."""
    return torch.where(key < 0, key ^ _LOW63, key).contiguous().view(torch.float64)


def _pack(v: torch.Tensor, idx) -> torch.Tensor:
    """(value, index) as one int64 whose order is the value's, then the
    lower index's."""
    return (_order_bits(v) << 32) | torch.as_tensor(idx, device=v.device).to(torch.int64)


def _value(key: torch.Tensor) -> torch.Tensor:
    """The float32 value a :func:`_pack` key carries."""
    bits = (key >> 32).to(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).contiguous().view(torch.float32)


def _first(key: torch.Tensor) -> torch.Tensor:
    """A reduced first-index key as a column (0 when no rank had one)."""
    return torch.where(key == _NONE, 0, key)


class PackedKeys:
    """The keys of a float32 solve: (value, index) packed into one int64
    (:func:`_pack`), an index-only key as the int64 itself; a MIN over the
    ranks is ONE all-reduce MIN of the key vector."""

    def pack(self, v: torch.Tensor, idx) -> torch.Tensor:
        return _pack(v, idx)

    def plain(self, i: torch.Tensor) -> torch.Tensor:
        return i.to(torch.int64)

    def reduce(self, keys: torch.Tensor, group, name: str) -> torch.Tensor:
        return all_reduce(keys, dist.ReduceOp.MIN, group, name)

    def smallest(self, keys: torch.Tensor, k: int) -> torch.Tensor:
        """The k smallest keys of a (N,) vector, ascending."""
        return torch.topk(keys, k, largest=False).values

    def value(self, key: torch.Tensor) -> torch.Tensor:
        return _value(key)

    def index(self, key: torch.Tensor) -> torch.Tensor:
        return key & _LOW32

    def plain_of(self, key: torch.Tensor) -> torch.Tensor:
        return key


class PairKeys:
    """The keys of a float64 solve, whose value key takes all 64 bits
    (:func:`_order_bits64`): a key is an int64 pair (value key, index), an
    index-only key the pair (index, 0), ordered lexicographically. A MIN
    over the ranks is ONE all-gather of the (k, 2) keys (16 bytes a key a
    rank), then the same lexicographic minimum on every rank, in rank
    order: as many collectives as :class:`PackedKeys`, and the minimum of
    each value in its own dtype (the reference's ``pmin``)."""

    def pack(self, v: torch.Tensor, idx) -> torch.Tensor:
        hi = _order_bits64(v)
        lo = torch.as_tensor(idx, device=v.device).to(torch.int64).expand_as(hi)
        return torch.stack([hi, lo], -1)

    def plain(self, i: torch.Tensor) -> torch.Tensor:
        hi = i.to(torch.int64)
        return torch.stack([hi, torch.zeros_like(hi)], -1)

    def reduce(self, keys: torch.Tensor, group, name: str) -> torch.Tensor:
        return _lex_min(all_gather(keys, group, name))

    def smallest(self, keys: torch.Tensor, k: int) -> torch.Tensor:
        """The k smallest pairs of a (N, 2) stack, ascending."""
        by_index = torch.sort(keys[:, 1], stable=True).indices
        order = by_index[torch.sort(keys[by_index, 0], stable=True).indices]
        return keys[order[:k]]

    def value(self, key: torch.Tensor) -> torch.Tensor:
        return _from_order_bits64(key[..., 0])

    def index(self, key: torch.Tensor) -> torch.Tensor:
        return key[..., 1]

    def plain_of(self, key: torch.Tensor) -> torch.Tensor:
        return key[..., 0]


def _lex_min(keys: torch.Tensor) -> torch.Tensor:
    """The lexicographic minimum over dim 0 of (..., 2) int64 pairs."""
    hi = keys[..., 0].min(0).values
    lo = torch.where(keys[..., 0] == hi, keys[..., 1], torch.iinfo(torch.int64).max).min(0).values
    return torch.stack([hi, lo], -1)


def key_codec(dtype: torch.dtype):
    """The keys of a solve in ``dtype``: :class:`PairKeys` for float64,
    :class:`PackedKeys` (the float32 path's, unchanged) otherwise."""
    return PairKeys() if dtype == torch.float64 else PackedKeys()


def make_collective_backend(
    group, base: int, n_loc: int, *, n: Optional[int] = None, kernels: str = "hopper",
    dtype: torch.dtype = torch.float32,
) -> types.SimpleNamespace:
    """The backend of a rank that owns columns [base, base + n_loc) of an
    (m, n) problem in ``dtype``, communicating over ``group``. ``kernels``
    names the rank's own op set (``"hopper"`` or ``"torch"``, as
    ``options.backend``); ``n`` (default ``n_loc``) sets the row chunks of a
    pricing pass over the whole shard; ``dtype`` the keys of its MINs
    (:func:`key_codec`). Column indices in and out are global."""
    local = get_backend(kernels)
    n = n_loc if n is None else int(n)
    keys_of = key_codec(dtype)

    def reduce(t, op, name):
        return all_reduce(t, op, group, name)

    def owned(idx):
        """(owned here, local position clamped into the shard)."""
        loc = idx.to(torch.int64) - base
        return (loc >= 0) & (loc < n_loc), loc.clamp(0, n_loc - 1)

    def owner_sum(vals, mine, name):
        return reduce(torch.where(mine, vals, 0), dist.ReduceOp.SUM, name)

    def scan(y, A, c, eps, basis, lo):
        # (min e, its lowest index, first index below -eps or INT_MAX) over
        # the rank's columns; a pass over the whole shard is chunked as the
        # pass over all n columns is
        if kernels == "hopper" and not isinstance(A, _sp.SparseA):
            chunk_n = n if A.shape[1] == n_loc else A.shape[1]
            return _hopper.pricing_scan(y, A, c, eps, None, basis, lo, chunk_n=chunk_n)
        return _hopper.pricing_scan_plain(y, A, c, eps, None, basis, lo)

    def choose_entering(y, A, c, eps, use_bland, basis=None, base_col=0):
        # A, c: the shard's columns, or the segment of them that starts at
        # shard column base_col
        lo = base + base_col
        min_e, arg, neg = scan(y, A, c, eps, basis, lo)
        keys = keys_of.reduce(torch.cat([
            keys_of.pack(min_e.view(1), arg.to(torch.int64).view(1) + lo),
            keys_of.plain(torch.where(neg == _ops.INT_MAX, _NONE, neg.to(torch.int64) + lo).view(1)),
        ]), group, "choose_entering")
        first = _first(keys_of.plain_of(keys[1]))
        p = torch.where(use_bland.view(()).to(torch.bool), first, keys_of.index(keys[0]))
        return p.to(torch.int32), keys_of.value(keys[0])

    def devex_choose(e, gamma, eps, use_bland):
        neg = e < -eps
        score = torch.where(neg, (e * e) / gamma, -math.inf)
        s = torch.argmax(score).view(1)
        first = torch.argmax(neg.to(torch.int32)).view(1)
        keys = keys_of.reduce(torch.cat([
            keys_of.pack(-score.index_select(0, s), s + base),
            keys_of.plain(torch.where(neg.any(), first + base, _NONE)),
            keys_of.pack(e.min().view(1), 0),
        ]), group, "devex_choose")
        p_bland = _first(keys_of.plain_of(keys[1]))
        p = torch.where(use_bland.view(()).to(torch.bool), p_bland, keys_of.index(keys[0]))
        return p.to(torch.int32), keys_of.value(keys[2])

    def gather_column_cost(A, c, p):
        mine, loc = owned(p.view(1))
        col, cost = local.gather_column_cost(A, c, loc.view(()))
        buf = owner_sum(torch.cat([col.to(c.dtype), cost.view(1)]), mine, "gather_column_cost")
        return buf[:-1], buf[-1]

    def gather_cost(v, p):
        mine, loc = owned(p.view(1))
        return owner_sum(v.index_select(0, loc), mine, "gather_cost").view(())

    def gather_costs(v, idx):
        mine, loc = owned(idx)
        return owner_sum(v.index_select(0, loc), mine, "init")

    def gather_basis_matrix(A, basis):
        mine, loc = owned(basis)
        return owner_sum(_ops.gather_basis_matrix(A, loc), mine[None, :], "gather_basis_matrix")

    def basis_columns64(A, basis):
        # the f64 polish's basis columns: from the device A when dense, from
        # the float64 host copy of the shard when sparse
        mine, loc = owned(basis.to(A.device))
        if isinstance(A, _sp.SparseA):
            cols = torch.as_tensor(_sp.gather_columns_host(A, loc.cpu().numpy()), device=A.device)
        else:
            cols = A.index_select(1, loc).double()
        return owner_sum(cols, mine[None, :], "basis_columns64")

    return types.SimpleNamespace(
        name=f"collective[{local.name}]",
        choose_entering=choose_entering,
        devex_choose=devex_choose,
        gather_column_cost=gather_column_cost,
        gather_cost=gather_cost,
        gather_costs=gather_costs,
        gather_basis_matrix=gather_basis_matrix,
        basis_columns64=basis_columns64,
        pricing_update=local.pricing_update,
        pivot_tail=local.pivot_tail,
        ratio_eta=local.ratio_eta,
        ratio_argmin=local.ratio_argmin,
        ratio_argmin_harris=local.ratio_argmin_harris,
        rank1_update=local.rank1_update,
    )


def shard_bounds(n: int, ranks: int) -> np.ndarray:
    """Column offsets of the ``ranks`` shards (``torch.tensor_split``'s
    split: the first n mod ranks shards hold one column more)."""
    sizes = np.full(ranks, n // ranks, np.int64)
    sizes[: n % ranks] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def _host_csc(A):
    """The scipy CSC host copy of a sparse A (scipy, a sparse tensor or a
    :class:`~simplex_tpu_torch.sparse.SparseA`)."""
    if isinstance(A, _sp.SparseA):
        return A.host
    if isinstance(A, torch.Tensor):  # a sparse tensor, as solve() takes it
        return _sp.as_sparse(A, torch.float64, "cpu").host
    return A.tocsc()


_UPLOAD_BYTES = 1 << 28  # bytes of A a block of rows of _local_columns


def _local_columns(A, lo: int, hi: int, dtype, device):
    """Columns [lo, hi) of the full A on ``device``: a sparse A (scipy, a
    sparse tensor or a :class:`~simplex_tpu_torch.sparse.SparseA`) as a
    SparseA of those columns alone (from the scipy CSC host copy), a dense
    one (numpy, a memmap, a tensor) as a contiguous block."""
    if _sp.is_sparse(A):
        return _sp.from_scipy(_host_csc(A)[:, lo:hi], dtype, device)
    if isinstance(A, torch.Tensor):
        return A[:, lo:hi].to(device=device, dtype=dtype).contiguous()
    # a block of rows at a time, each converted on the host as it is copied
    # in: no whole staging copy in A's own dtype beside the result
    out = torch.empty((A.shape[0], hi - lo), dtype=dtype, device=device)
    rows = max(1, _UPLOAD_BYTES // max(1, (hi - lo) * A.dtype.itemsize))
    for r in range(0, A.shape[0], rows):
        out[r : r + rows].copy_(torch.from_numpy(np.ascontiguousarray(A[r : r + rows, lo:hi])))
    return out


def _initial_state_sharded(prob: Problem, basis0: torch.Tensor, backend, opts) -> SolverState:
    """``simplex_tpu.dist.sharded._initial_state_sharded``: the start from
    a basis whose columns form the identity (B_inv = I, x_b = b, y = c_b),
    c_b gathered from the owning ranks; devex's e = c_b.A - c on the shard
    and unit weights. No perturbation state and no candidate buffer, as in
    the reference's sharded state."""
    dtype, dev = opts.dtype, prob.b.device
    m = prob.b.shape[0]
    c_b = backend.gather_costs(prob.c, basis0).to(dtype)
    return SolverState(
        B_inv=torch.eye(m, dtype=dtype, device=dev),
        x_b=prob.b.clone(),
        y=c_b.clone(),
        c_b=c_b,
        basis=basis0,
        iters=_int(0, dev),
        status=_int(SolveStatus.RUNNING, dev),
        degen=_int(0, dev),
        last_refac=_int(0, dev),
        **_defer_extras(m, dtype, dev, opts.update_defer),
        **_pricing_extras(prob, c_b, dtype, opts.pricing),
    )


def solve_sharded(
    A,
    b,
    c,
    mesh,
    *,
    basis0=None,
    options: SimplexOptions = DEFAULT_OPTIONS,
    axis_name: str = COLS_AXIS,
    device=None,
) -> SolveResult:
    """Solve  max c.x  s.t.  A x = b, x >= 0  with the columns of A sharded
    over the ranks of ``mesh``'s axis ``axis_name`` (a
    :class:`~torch.distributed.device_mesh.DeviceMesh`,
    :func:`~simplex_tpu_torch.dist.mesh.make_mesh`). Every rank of that
    axis calls it with the same arguments and returns the same result.

    ``A`` is the full matrix on every rank (numpy, a memmap, a tensor, or
    sparse: scipy.sparse, a sparse tensor or a :class:`~simplex_tpu_torch.sparse.SparseA`);
    each rank moves only its own columns to ``device`` (default: the
    mesh's device type, on the current card). Any n of at least one
    column a rank is taken; shards may differ in width by one column.
    ``basis0`` (default: the trailing slack block) must satisfy
    A[:, basis0] = I. The result is polished in float64 as the single
    solve's is, with the basis columns gathered from their ranks."""
    options = check_supported(options)
    if options.multi_price > 0:
        get_logger("dist").warning(
            "multi_price=%d is inert in the 1-D sharded mode (supported "
            "single-chip and in solve_sharded_2d); solving without "
            "multiple pricing", options.multi_price
        )
        options = dataclasses.replace(options, multi_price=0)
    if options.pricing == "steepest":
        raise NotImplementedError(
            "pricing='steepest' is single-chip only (its weight scatter "
            "needs global column addressing); use devex for sharded solves"
        )
    b, c = (np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for v in (b, c))
    if not isinstance(A, torch.Tensor) and not _sp.is_sparse(A) and not hasattr(A, "shape"):
        A = np.asarray(A)
    m, n = A.shape
    if m > n:
        raise ValueError(f"m > n ({m} > {n}): not a canonical-form LP")
    if b.shape != (m,) or c.shape != (n,):
        raise ValueError(f"shape mismatch: A {A.shape}, b {b.shape}, c {c.shape}")
    group = require_mesh(mesh).get_group(axis_name)
    ranks = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n < ranks:
        raise ValueError(f"n={n} columns cannot be sharded over {ranks} ranks")
    bounds = shard_bounds(n, ranks)
    lo, hi = int(bounds[rank]), int(bounds[rank + 1])
    sparse = _sp.is_sparse(A)
    S = options.partial_pricing
    if options.pricing == "dantzig" and not sparse and S > 1:
        # segmented pricing is decided per shard (as in the reference); on
        # uneven shards that decision must not differ between ranks
        active = {
            int(w) % S == 0 and int(w) // S >= options.partial_min_segment
            for w in np.diff(bounds)
        }
        if len(active) > 1:
            raise ValueError(
                f"partial_pricing={S}: shards of {sorted(set(np.diff(bounds).tolist()))} "
                "columns disagree on segmented pricing; pick n or partial_pricing so "
                "that they agree"
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
    backend = make_collective_backend(group, lo, hi - lo, n=n, kernels=options.backend, dtype=dtype)
    basis0 = np.arange(n - m, n) if basis0 is None else np.asarray(basis0)
    basis0 = torch.as_tensor(basis0.astype(np.int32), device=device)
    state0 = _initial_state_sharded(prob, basis0, backend, options)
    final = solve_state(prob, state0, options, options.resolve_max_iter(m, n), backend)
    return finalize_result(prob, b, c, final, options, basis_columns=backend.basis_columns64)
