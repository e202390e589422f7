"""Column-sharded PDHG over a mesh of ranks (``torch.distributed``).

The counterpart of ``simplex_tpu.fo.sharded``: the columns of A (and x, c,
u) are split over the ranks of one mesh axis, y and b are replicated. An
iteration is

    x+ = min(max(0, x - tau (c - A^T y)), u)    A^T y is shard-local
    y+ = y + sigma (b - A (2 x+ - x))           A x: a local product and
                                                ONE all-reduce SUM of m floats

so a rank holds only its shard of A and no inverse. The scheme is the
reference's sharded one, not the single card's: Ruiz equilibration and the
power iteration run over the shards (the power iteration starts from the
global ramp 1..n), the steps and scales follow ``simplex_tpu/fo/
sharded.py:41-97``, the primal weight always adapts (at restarts only), and
the state is the reference's 15 leaves

    (x, y, cnt, lre, it, sx, rp, rd, gp, stall, sy, tau, sigma, xr, yr)

with x, sx, xr column-sharded and the rest replicated. After each
``check_every`` iterations the window's KKT errors of the iterate and of
the running average take ONE all-reduce SUM (both points' A x, their
objective terms and the squared movement ||x - x_r||^2 a restart needs)
and ONE all-reduce MAX (their dual residuals), then the restart and the
weight update run on replicated values; the host reads the window's
residuals once. Every rank makes the same decisions and returns the same
result.

Products are ``torch.mv`` in full fp32 (TF32 off) for a dense shard and
cuSPARSE SpMVs for a sparse one (CSR of the rank's own columns, built from
the scipy CSC host copy), as in :mod:`simplex_tpu_torch.fo.pdhg`: no Pallas
kernel is on this path in the reference either. Shards may be uneven
(``torch.tensor_split``'s split) where the reference asks for n divisible
by the axis. A non-convergent exit certifies infeasibility or
unboundedness with the single card's ``_certify``, its products taken on
each rank's own columns of the caller's A (float64 on the host, a block of
columns at a time) with one all-reduce each, so that no rank holds the
whole A in float64; only the f64 polish of a primal ray, which the single
card too runs up to 2^24 entries of A, takes the whole A there.
"""

from __future__ import annotations

import math
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.config import pin_full_fp32
from simplex_tpu_torch.dist.mesh import COLS_AXIS, require_mesh
from simplex_tpu_torch.dist.sharded import _host_csc, _local_columns, all_reduce, default_device, shard_bounds
from simplex_tpu_torch.fo.pdhg import (
    BETA_NEC,
    BETA_SUF,
    STALL_WINDOWS,
    PDHGResult,
    _absmax,
    _certify,
    _col_absmax,
    _mv,
    _polish_primal_ray,
    _rmv,
    _row_absmax,
    _scale,
)
from simplex_tpu_torch.status import SolveStatus

# the state tuple's leaves, in ``simplex_tpu.fo.sharded``'s order
STATE_LEAVES = (
    "x", "y", "cnt", "lre", "it", "sx", "rp", "rd", "gp", "stall", "sy", "tau", "sigma", "xr", "yr",
)
_INTS = ("cnt", "it", "stall")
_SHARDED = ("x", "sx", "xr")


class _Shard:
    """One rank's view of the problem: its columns [lo, hi), the axis group,
    and the products that communicate."""

    def __init__(self, group, lo: int, hi: int):
        self.group, self.lo, self.hi = group, lo, hi

    def sum(self, t: torch.Tensor, name: str) -> torch.Tensor:
        return all_reduce(t, dist.ReduceOp.SUM, self.group, name)

    def max(self, t: torch.Tensor, name: str) -> torch.Tensor:
        return all_reduce(t, dist.ReduceOp.MAX, self.group, name)

    def matvec(self, As, x_loc: torch.Tensor, name: str = "pdhg_matvec") -> torch.Tensor:
        return self.sum(_mv(As, x_loc), name)


def _setup(sh: _Shard, A_loc, b: torch.Tensor, c_loc: torch.Tensor):
    """``simplex_tpu.fo.sharded._setup_local``: distributed Ruiz scaling,
    the power iteration from the global ramp, the balanced steps and the
    scales of the original data. Returns ``(As, dr, dc, bs, cs, tau0,
    sigma0, b_scale, c_scale)``."""
    dtype, dev = torch.float32, b.device
    m, n_loc = A_loc.shape
    ones_m = torch.ones(m, dtype=dtype, device=dev)
    ones_n = torch.ones(n_loc, dtype=dtype, device=dev)
    sparse = isinstance(A_loc, _sp.SparseA)
    As, dr, dc = A_loc, ones_m, ones_n
    for _ in range(10):
        # an all-zero row or column scales by 1; a dense shard divides, as
        # the reference does
        mr = sh.max(_row_absmax(As).contiguous(), "pdhg_setup")
        r = torch.sqrt(torch.where(mr > 0, mr, 1))
        As = _scale(As, 1 / r, ones_n) if sparse else As / r[:, None]
        dr = dr * r
        mc = _col_absmax(As)
        cc = torch.sqrt(torch.where(mc > 0, mc, 1))
        As = _scale(As, ones_m, 1 / cc) if sparse else As / cc[None, :]
        dc = dc * cc
    bs = b / dr
    cs = -c_loc / dc  # minimization form

    def norm_all(v):
        return torch.sqrt(sh.sum((v * v).sum().view(1), "pdhg_setup")).view(())

    # the ramp 1..n over the whole matrix: never orthogonal to the top
    # singular subspace, as all-ones can be
    v = torch.arange(sh.lo + 1, sh.hi + 1, dtype=dtype, device=dev)
    v = v / norm_all(v)
    for _ in range(30):
        v = _rmv(As, sh.matvec(As, v, "pdhg_setup"))
        v = v / torch.clamp_min(norm_all(v), 1e-30)
    peaks = sh.max(torch.stack([_absmax(As), c_loc.abs().max()]), "pdhg_setup")
    nrm = torch.maximum(torch.linalg.vector_norm(sh.matvec(As, v, "pdhg_setup")), peaks[0])
    w0 = torch.sqrt((norm_all(cs) + 1e-6) / (torch.linalg.vector_norm(bs) + 1e-6))
    eta = 0.9 / torch.clamp_min(nrm, 1e-30)
    # scales in the original units (the residuals map back through dr / dc)
    b_scale = 1 + b.abs().max()
    c_scale = 1 + peaks[1]
    return As, dr, dc, bs, cs, eta / w0, eta * w0, b_scale, c_scale


def _window(sh: _Shard, As, bs, cs, dr, dc, b_scale, c_scale, us, state, tol: float, check_every: int):
    """``check_every`` iterations, then the KKT errors of the iterate and of
    the average, the restart (to the average when it is better), the
    primal weight at a restart, and the stall count: one window of
    ``simplex_tpu.fo.sharded._chunk_core``. Reads nothing on the host."""
    x, y, cnt, lre, it, sx, rp0, rd0, gp0, stall, sy, tau, sigma, xr, yr = state
    for _ in range(check_every):
        x1 = torch.minimum(torch.clamp_min(x - tau * (cs - _rmv(As, y)), 0), us)
        y = y + sigma * (bs - sh.matvec(As, 2 * x1 - x))
        x = x1
        sx = sx + x
        sy = sy + y
    cnt1 = cnt + check_every
    xa, ya = sx / cnt1, sy / cnt1
    m = bs.shape[0]
    finite = torch.isfinite(us)
    u0 = torch.where(finite, us, 0)

    def partials(xp, yp):
        red = cs - _rmv(As, yp)
        rd_loc = torch.where(finite, 0, dc * torch.clamp_min(-red, 0)).max()
        terms = torch.stack([
            torch.dot(cs, xp),  # the primal objective's part
            (u0 * torch.clamp_max(red, 0)).sum(),  # the finite-u columns' dual part
            ((xp - xr) * (xp - xr)).sum(),  # the movement, should xp be kept
        ])
        return rd_loc, terms

    rd_c, t_c = partials(x, y)
    rd_a, t_a = partials(xa, ya)
    # both points' A x and their scalar terms in one SUM, the dual residuals
    # in one MAX
    buf = sh.sum(torch.cat([_mv(As, x), _mv(As, xa), t_c, t_a]), "pdhg_kkt")
    rd_c, rd_a = (sh.max(torch.stack([rd_c, rd_a]), "pdhg_kkt") / c_scale).unbind(0)
    Ax_c, Ax_a, t_c, t_a = buf[:m], buf[m : 2 * m], buf[2 * m : 2 * m + 3], buf[2 * m + 3 :]

    def errors(Ax, yp, t, rd):
        rp = (dr * (Ax - bs)).abs().max() / b_scale
        pobj, dobj = t[0], torch.dot(bs, yp) + t[1]
        gap = (pobj - dobj).abs() / (1 + pobj.abs() + dobj.abs())
        return rp, rd, gap

    rp_c, rd_c, gp_c = errors(Ax_c, y, t_c, rd_c)
    rp_a, rd_a, gp_a = errors(Ax_a, ya, t_a, rd_a)
    err_c = torch.maximum(torch.maximum(rp_c, rd_c), gp_c)
    err_a = torch.maximum(torch.maximum(rp_a, rd_a), gp_a)
    err = torch.minimum(err_c, err_a)
    err_prev = torch.maximum(torch.maximum(rp0, rd0), gp0)
    restart = (err <= BETA_SUF * lre) | ((err <= BETA_NEC * lre) & (err > err_prev)) | (err < tol)
    adopt = restart & (err_a < err_c)
    x2 = torch.where(adopt, xa, x)
    y2 = torch.where(adopt, ya, y)
    # PDLP's smoothed primal weight at restart epochs, clipped to [1e-4, 1e4]
    dxn = torch.sqrt(torch.where(adopt, t_a[2], t_c[2]))
    dyn = torch.linalg.vector_norm(y2 - yr)
    w_old = torch.sqrt(sigma / tau)
    eta = torch.sqrt(sigma * tau)
    valid = (dxn > 1e-12) & (dyn > 1e-12)
    w_new = torch.where(valid, torch.sqrt((dyn / dxn) * w_old), w_old).clamp(1e-4, 1e4)
    return (
        x2, y2, torch.where(restart, 0, cnt1), torch.where(restart, err, lre), it + check_every,
        torch.where(restart, 0, sx), torch.where(adopt, rp_a, rp_c), torch.where(adopt, rd_a, rd_c),
        torch.where(adopt, gp_a, gp_c), torch.where(err < err_prev * (1 - 1e-4), 0, stall + 1),
        torch.where(restart, 0, sy), torch.where(restart, eta / w_new, tau),
        torch.where(restart, eta * w_new, sigma), torch.where(restart, x2, xr), torch.where(restart, y2, yr),
    )


def pdhg_sharded_state_from_numpy(
    leaves: Mapping[str, object], lo: int, hi: int, device, dtype=torch.float32
) -> tuple:
    """A rank's sharded PDHG state from a global one: the reference's 15
    leaves (x, y, cnt, lre, it, sx, rp, rd, gp, stall, sy, tau, sigma, xr,
    yr; a mapping by those names or a sequence in that order), x / sx / xr
    cut to the rank's columns [lo, hi), so that both packages can run a
    window from identical inputs."""
    if not isinstance(leaves, Mapping):
        leaves = dict(zip(STATE_LEAVES, leaves))
    out = []
    for f in STATE_LEAVES:
        v = np.array(leaves[f])
        if f in _SHARDED:
            v = v[lo:hi]
        out.append(torch.as_tensor(v, device=device).to(torch.int32 if f in _INTS else dtype))
    return tuple(out)


def _initial_state(m: int, n_loc: int, device, tau0, sigma0) -> tuple:
    def z(k):
        return torch.zeros(k, dtype=torch.float32, device=device)

    def i0():
        return torch.zeros((), dtype=torch.int32, device=device)

    inf = torch.full((), math.inf, dtype=torch.float32, device=device)
    return (
        z(n_loc), z(m), i0(), inf, i0(), z(n_loc), inf.clone(), inf.clone(), inf.clone(), i0(), z(m),
        tau0, sigma0, z(n_loc), z(m),
    )


def _host(v) -> np.ndarray:
    return np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v, np.float64)


def prepare(A, b, c, mesh, *, u=None, axis_name: str = COLS_AXIS, device=None):
    """The set-up of :func:`solve_pdhg_sharded` on this rank: ``(sh,
    data, u_np)`` with ``data`` = ``(As, bs, cs, dr, dc, b_scale, c_scale,
    us, tau0, sigma0)``, the rank's scaled shard and the replicated
    scalars."""
    mesh = require_mesh(mesh)
    return prepare_on(A, b, c, mesh.get_group(axis_name), u=u, device=default_device(mesh, device))


def prepare_on(A, b, c, group, *, u=None, device):
    """:func:`prepare` over a process group of its own (the ranks of one
    mesh axis, or any group), on ``device``."""
    ranks, rank = dist.get_world_size(group), dist.get_rank(group)
    b_np, c_np = _host(b), _host(c)
    m, n = A.shape
    if b_np.shape != (m,) or c_np.shape != (n,):
        raise ValueError(f"shape mismatch: A {(m, n)}, b {b_np.shape}, c {c_np.shape}")
    if n < ranks:
        raise ValueError(f"n={n} columns cannot be sharded over {ranks} ranks")
    u_np = np.full(n, np.inf) if u is None else _host(u)
    if u is not None and np.any(u_np < 0):
        raise ValueError("negative upper bound (shift lowers to 0 first)")
    device = torch.device(device)
    bounds = shard_bounds(n, ranks)
    lo, hi = int(bounds[rank]), int(bounds[rank + 1])
    sh = _Shard(group, lo, hi)
    A_loc = _local_columns(A, lo, hi, torch.float32, device)
    b_t = torch.as_tensor(b_np, device=device).to(torch.float32)
    c_loc = torch.as_tensor(c_np[lo:hi], device=device).to(torch.float32)
    As, dr, dc, bs, cs, tau0, sigma0, b_scale, c_scale = _setup(sh, A_loc, b_t, c_loc)
    # scaled bounds: x = xs / dc, so xs <= u dc
    us = torch.as_tensor(u_np[lo:hi], device=device).to(torch.float32) * dc
    return sh, (As, bs, cs, dr, dc, b_scale, c_scale, us, tau0, sigma0), u_np


def run_windows(sh: _Shard, data, state, tol: float, max_iter: int, check_every: int):
    """Windows from ``state`` until the KKT errors are below ``tol``, the
    stall count reaches 64 windows or ``max_iter`` iterations ran, with the
    window's one host read. Returns ``(state, (rp, rd, gp, it, stall))``."""
    As, bs, cs, dr, dc, b_scale, c_scale, us = data[:8]
    vals = torch.stack([state[i].double() for i in (6, 7, 8, 4, 9)]).tolist()
    while not (max(vals[:3]) < tol or vals[3] >= max_iter or vals[4] >= STALL_WINDOWS):
        state = _window(sh, As, bs, cs, dr, dc, b_scale, c_scale, us, state, float(tol), int(check_every))
        # the window's one read, of replicated values
        vals = torch.stack([state[i].double() for i in (6, 7, 8, 4, 9)]).tolist()
    return state, (vals[0], vals[1], vals[2], int(vals[3]), int(vals[4]))


def solve_pdhg_sharded(
    A,
    b,
    c,
    mesh,
    *,
    u=None,
    tol: float = 1e-4,
    max_iter: int = 1_000_000,
    check_every: int = 128,
    axis_name: str = COLS_AXIS,
    device=None,
) -> PDHGResult:
    """Solve  max c.x  s.t.  A x = b, 0 <= x (<= u)  by PDHG with the columns
    of A split over the ranks of ``mesh``'s axis ``axis_name`` (a
    :class:`~torch.distributed.device_mesh.DeviceMesh` from
    :func:`~simplex_tpu_torch.dist.mesh.make_mesh`). Every rank of that
    axis calls it with the same arguments and returns the same result.

    Same arguments and result as ``simplex_tpu.fo.sharded.solve_pdhg_sharded``
    plus ``device`` (default: the mesh's device type, on the current card).
    ``A`` is the full matrix on every rank (dense: numpy, a memmap, a
    tensor; sparse: scipy.sparse, a sparse tensor or a
    :class:`~simplex_tpu_torch.sparse.SparseA`), of which each rank moves
    only its own columns to ``device``; shards may differ in width by one
    column. ``u`` (n,) with +inf for an unbounded column shards with the
    columns. The arithmetic is float32 with fixed steps of the reference's
    sharded scheme (adaptive primal weight at restarts, no ``dtype``,
    ``adaptive_weight`` or ``cert_tol`` arguments)."""
    pin_full_fp32()
    if not isinstance(A, torch.Tensor) and not _sp.is_sparse(A) and not hasattr(A, "shape"):
        A = np.asarray(A)
    sh, data, u_np = prepare(A, b, c, mesh, u=u, axis_name=axis_name, device=device)
    m, n_loc = data[1].shape[0], data[2].shape[0]
    state = _initial_state(m, n_loc, data[1].device, data[8], data[9])
    state, (rp, rd, gp, it, stall) = run_windows(sh, data, state, tol, max_iter, check_every)
    return finish(sh, data, state, (rp, rd, gp, it, stall), A, b, c, u_np, tol)


def finish(sh: _Shard, data, state, read, A, b, c, u_np, tol) -> PDHGResult:
    """The result from a final state (``simplex_tpu/fo/sharded.py:505-545``):
    x and the epoch's anchor gathered in original units, the certificates
    of a non-convergent exit from the shards (:class:`_ShardCert`)."""
    dr, dc = data[3], data[4]
    rp, rd, gp, it, stall = read
    n = len(c)
    full = torch.zeros((2, n), dtype=torch.float32, device=dc.device)
    full[0, sh.lo : sh.hi] = state[0] / dc
    full[1, sh.lo : sh.hi] = state[13] / dc
    full = sh.sum(full, "pdhg_result").double().cpu().numpy()
    x = full[0]
    y = (state[1] / dr).double().cpu().numpy()
    ray_p = ray_d = None
    if max(rp, rd, gp) < tol:
        status = SolveStatus.OPTIMAL
    else:
        b64 = _host(b)
        cmin = -_host(c)
        yr = (state[14] / dr).double().cpu().numpy()
        ops = _ShardCert(sh, A, b64, cmin, u_np, dc.device)
        cert, ray_p, ray_d = _certify(
            ops, x, y, full[1], yr, 1 + float(np.abs(b64).max()), 1 + float(np.abs(cmin).max()), 1e-5, u_np,
        )
        if cert is not None:
            status = cert
        elif stall >= STALL_WINDOWS:
            status = SolveStatus.SINGULAR
        else:
            status = SolveStatus.MAX_ITER
    return PDHGResult(
        z=float(_host(c) @ x), x=x, y=-y, status=status, iters=it,
        primal_res=rp, dual_res=rd, gap=gp, ray_primal=ray_p, ray_dual=ray_d,
    )


CERT_BLOCK = 1 << 22  # entries of A a certificate product takes into float64 at a time


def _column_blocks(A, lo: int, hi: int):
    """Columns [lo, hi) of the caller's A in float64 on the host, as
    ``(offset, block)`` pairs: a sparse A's CSC slice at once, a dense one
    ``CERT_BLOCK`` entries at a time."""
    if _sp.is_sparse(A):
        yield 0, _host_csc(A)[:, lo:hi].astype(np.float64)
        return
    step = max(1, CERT_BLOCK // max(A.shape[0], 1))
    for j in range(lo, hi, step):
        blk = A[:, j : min(j + step, hi)]
        yield j - lo, np.asarray(blk.detach().cpu() if isinstance(blk, torch.Tensor) else blk, np.float64)


class _ShardCert:
    """The certificate's products (``fo/pdhg.py`` ``_HostCert``) on this
    rank's columns [lo, hi) of the caller's A, in float64 on the host: A
    xhat as the ranks' partial products and ONE all-reduce SUM of m
    floats; A^T yhat on the rank's own columns, then ONE SUM (the finite
    bounds' share) and ONE MAX (the violation). Every rank calls them with
    the same replicated rays and gets the same numbers."""

    def __init__(self, sh: _Shard, A, b, cmin, u, device):
        self.sh, self.A, self.b, self.cmin, self.device = sh, A, b, cmin, device
        self.u_loc = u[sh.lo : sh.hi]
        self.finite = np.isfinite(self.u_loc)

    def _reduce(self, v: np.ndarray, op) -> np.ndarray:
        t = torch.as_tensor(np.asarray(v, np.float64), device=self.device)
        return all_reduce(t, op, self.sh.group, "pdhg_cert").cpu().numpy()

    def primal(self, xhat):
        x_loc = xhat[self.sh.lo : self.sh.hi]
        ax = np.zeros(len(self.b))
        for j, blk in _column_blocks(self.A, self.sh.lo, self.sh.hi):
            ax += blk @ x_loc[j : j + blk.shape[1]]
        ax = self._reduce(ax, dist.ReduceOp.SUM)
        return float(np.max(np.abs(ax))) if ax.size else 0.0, float(self.cmin @ xhat)

    def dual(self, yhat):
        pos = np.zeros(self.sh.hi - self.sh.lo)
        for j, blk in _column_blocks(self.A, self.sh.lo, self.sh.hi):
            pos[j : j + blk.shape[1]] = np.maximum(np.asarray(blk.T @ yhat).ravel(), 0)
        viol = np.max(np.where(self.finite, 0, pos), initial=0.0)
        share = self._reduce([np.sum(np.where(self.finite, self.u_loc, 0) * pos)], dist.ReduceOp.SUM)
        viol = self._reduce([viol], dist.ReduceOp.MAX)
        return float(viol[0]), float(self.b @ yhat - share[0])

    def polish(self, d, fixed):
        """The single card's f64 polish, on the whole A: it runs only up to
        2^24 entries (128 MiB in float64), so nothing larger is built."""
        m, n = self.A.shape
        if m * n > (1 << 24):
            return d
        A = self.A
        if _sp.is_sparse(A):
            A64 = _host_csc(A).astype(np.float64)
        else:
            A64 = np.asarray(A.detach().cpu() if isinstance(A, torch.Tensor) else A, np.float64)
        return _polish_primal_ray(A64, d, fixed)
