"""PDHG (PDLP-style) first-order LP solver on the port: the inverse-free mode.

The counterpart of ``simplex_tpu.fo.pdhg``. It solves the simplex core's
canonical problem

    max c.x   s.t.   A x = b,  0 <= x (<= u)

by the primal-dual hybrid gradient method with Ruiz equilibration, a
power-iteration step size, restarts to the average (PDLP's sufficient 0.2
and necessary 0.8 decay) and the smoothed adaptive primal weight. One
iteration (minimization form, f = min -c.x) is two products and O(m + n)
elementwise work:

    x+ = min(max(0, x - tau (c_min - A^T y)), u)
    y+ = y + sigma (b - A (2 x+ - x))

No Pallas kernel is on this path in the JAX package (XLA runs it), so the
port runs it as plain torch: ``torch.mv`` in full fp32 (TF32 off, JAX's
``Precision.HIGHEST``) for a dense A, the cuSPARSE SpMVs of
:mod:`simplex_tpu_torch.sparse` for a sparse one. The loop runs in
``check_every`` windows: the iterations of a window are device work with
no host read; the KKT errors of the iterate and of the running average,
the restart and the weight update are computed on the device after it; the
host reads the window's residuals and stall count ONCE a window to decide
whether to stop (the JAX package decides the same inside its device loop).

Non-convergent exits run PDLP's infeasibility detection on the divergent
iterate ray (:func:`_certify`): INFEASIBLE with a Farkas ray, UNBOUNDED
with a recession ray, SINGULAR after 64 windows without progress, else
MAX_ITER.
"""

from __future__ import annotations

import math
from typing import Mapping, NamedTuple, Optional

import numpy as np
import torch

from simplex_tpu_torch import sparse as _sp
from simplex_tpu_torch.config import pin_full_fp32
from simplex_tpu_torch.status import SolveStatus

STALL_WINDOWS = 64
BETA_SUF = 0.2  # sufficient-decay restart factor
BETA_NEC = 0.8  # necessary decay (PDLP's artificial restart)
# the state tuple's leaves, in ``simplex_tpu.fo.pdhg``'s order
STATE_LEAVES = (
    "x", "y", "sx", "sy", "cnt", "lre", "it", "rp", "rd", "gp", "stall", "tau", "sigma",
    "xr", "yr",
)


# ---- the six ops PDHG applies to A: dense tensor or SparseA ------------


def _mv(A, x):
    if isinstance(A, _sp.SparseA):
        return _sp.matvec(A, x)
    return torch.mv(A, x)


def _rmv(A, y):
    if isinstance(A, _sp.SparseA):
        return _sp.rmatvec(A, y)
    return y @ A


def _row_absmax(A):
    if isinstance(A, _sp.SparseA):
        return _sp.row_absmax(A)
    return A.abs().amax(1)


def _col_absmax(A):
    if isinstance(A, _sp.SparseA):
        return _sp.col_absmax(A)
    return A.abs().amax(0)


def _absmax(A):
    if isinstance(A, _sp.SparseA):
        return _sp.absmax(A)
    return A.abs().max()


def _scale(A, r, c):
    """diag(r) A diag(c)."""
    if isinstance(A, _sp.SparseA):
        return _sp.scale(A, r, c)
    return A * r[:, None] * c[None, :]


class PDHGResult(NamedTuple):
    z: float
    x: np.ndarray  # (n,) primal solution
    y: np.ndarray  # (m,) dual solution (equality multipliers)
    status: SolveStatus
    iters: int
    primal_res: float  # ||A x - b||_inf / (1 + ||b||_inf)
    dual_res: float  # ||min(c_min - A^T y, 0)||_inf / (1 + ||c||_inf)
    gap: float  # |c.x - b.y| / (1 + |c.x| + |b.y|)
    # certificates of a non-convergent exit (unit inf-norm, original units):
    # INFEASIBLE pairs with ray_dual (A^T r <= 0, b.r > 0), UNBOUNDED with
    # ray_primal (d >= 0, A d = 0, c.d > 0)
    ray_primal: Optional[np.ndarray] = None
    ray_dual: Optional[np.ndarray] = None


def _ruiz_equilibrate(A, iters: int = 10, dtype=torch.float32):
    """Ruiz scaling ``(D_r A D_c, d_r, d_c)``: rows and columns pulled
    toward unit inf-norm in ``iters`` sweeps, in the solve's dtype; an
    all-zero row or column scales by 1."""
    m, n = A.shape
    dev = A.device
    ones_m = torch.ones(m, dtype=dtype, device=dev)
    ones_n = torch.ones(n, dtype=dtype, device=dev)
    As = A.to(dtype=dtype) if isinstance(A, _sp.SparseA) else A.to(dtype)
    dr, dc = ones_m, ones_n
    for _ in range(iters):
        mr = _row_absmax(As)
        r = torch.sqrt(torch.where(mr > 0, mr, 1))
        As = _scale(As, 1 / r, ones_n)
        dr = dr * r
        mc = _col_absmax(As)
        c = torch.sqrt(torch.where(mc > 0, mc, 1))
        As = _scale(As, ones_m, 1 / c)
        dc = dc * c
    return As, dr, dc


def _spectral_norm(A, iters: int = 30):
    """||A||_2 by power iteration on A^T A from the ramp 1..n (never
    orthogonal to the top singular subspace, as all-ones can be), floored
    at max |A_ij|, a lower bound of the norm."""
    n = A.shape[1]
    v = torch.arange(1, n + 1, dtype=A.dtype, device=A.device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        v = _rmv(A, _mv(A, v))
        v = v / torch.clamp_min(torch.linalg.vector_norm(v), 1e-30)
    return torch.maximum(torch.linalg.vector_norm(_mv(A, v)), _absmax(A))


def _kkt(A, b, cmin, x, y, dr, dc, b_scale, c_scale, us):
    """(primal_res, dual_res, gap): the relative inf-norm KKT errors of the
    ORIGINAL problem evaluated on the scaled system (A x - b = D_r (As xs -
    bs), reduced costs dc * (cs - ys As)); a finite-u column puts its
    negative reduced cost into the dual objective, not the residual."""
    r_p = (dr * (_mv(A, x) - b)).abs().max() / b_scale
    red = cmin - _rmv(A, y)
    finite = torch.isfinite(us)
    r_d = torch.where(finite, 0, dc * torch.clamp_min(-red, 0)).max() / c_scale
    pobj = torch.dot(cmin, x)
    dobj = torch.dot(b, y) + (torch.where(finite, us, 0) * torch.clamp_max(red, 0)).sum()
    gap = (pobj - dobj).abs() / (1 + pobj.abs() + dobj.abs())
    return r_p, r_d, gap


def _pdhg_setup(A, b, cmin, dtype):
    """Ruiz scaling, the spectral norm, the balanced steps and the scales
    of the original data: ``(As, dr, dc, bs, cs, tau0, sigma0, b_scale,
    c_scale)``."""
    As, dr, dc = _ruiz_equilibrate(A, dtype=dtype)
    bs = b.to(dtype) / dr
    cs = cmin.to(dtype) / dc
    nrm = _spectral_norm(As)
    w0 = torch.sqrt((torch.linalg.vector_norm(cs) + 1e-6) / (torch.linalg.vector_norm(bs) + 1e-6))
    eta = 0.9 / torch.clamp_min(nrm, 1e-30).to(dtype)
    b_scale = 1 + b.to(dtype).abs().max()
    c_scale = 1 + cmin.to(dtype).abs().max()
    return As, dr, dc, bs, cs, eta / w0, eta * w0, b_scale, c_scale


def _pdhg_window(As, bs, cs, dr, dc, b_scale, c_scale, us, state, tol, check_every, adaptive):
    """``check_every`` iterations, then the window's KKT errors (iterate and
    average), the restart test, the primal-weight update and the stall
    count (``simplex_tpu.fo.pdhg._pdhg_chunk``'s ``_pdhg_window``). Reads
    nothing on the host."""
    x, y, sx, sy, cnt, lre, it, rp0, rd0, gp0, stall, tau, sigma, xr, yr = state
    for _ in range(check_every):
        red = cs - _rmv(As, y)
        x1 = torch.minimum(torch.clamp_min(x - tau * red, 0), us)
        y = y + sigma * (bs - _mv(As, 2 * x1 - x))
        x = x1
        sx = sx + x
        sy = sy + y
    cnt1 = cnt + check_every
    xa = sx / cnt1
    ya = sy / cnt1
    rp_c, rd_c, gp_c = _kkt(As, bs, cs, x, y, dr, dc, b_scale, c_scale, us)
    rp_a, rd_a, gp_a = _kkt(As, bs, cs, xa, ya, dr, dc, b_scale, c_scale, us)
    err_c = torch.maximum(torch.maximum(rp_c, rd_c), gp_c)
    err_a = torch.maximum(torch.maximum(rp_a, rd_a), gp_a)
    err = torch.minimum(err_c, err_a)
    err_prev = torch.maximum(torch.maximum(rp0, rd0), gp0)
    restart = (err <= BETA_SUF * lre) | ((err <= BETA_NEC * lre) & (err > err_prev)) | (err < tol)
    adopt_avg = restart & (err_a < err_c)
    x2 = torch.where(adopt_avg, xa, x)
    y2 = torch.where(adopt_avg, ya, y)
    sx2 = torch.where(restart, 0, sx)
    sy2 = torch.where(restart, 0, sy)
    cnt2 = torch.where(restart, 0, cnt1)
    lre2 = torch.where(restart, err, lre)
    if adaptive:
        # PDLP's smoothed primal weight, at restarts only: w' = sqrt(w *
        # ||dy|| / ||dx||) over the finished epoch, clipped to [1e-4, 1e4]
        dxn = torch.linalg.vector_norm(x2 - xr)
        dyn = torch.linalg.vector_norm(y2 - yr)
        w_old = torch.sqrt(sigma / tau)
        eta = torch.sqrt(sigma * tau)
        valid = (dxn > 1e-12) & (dyn > 1e-12)
        w_new = torch.where(valid, torch.sqrt((dyn / dxn) * w_old), w_old).clamp(1e-4, 1e4)
        tau = torch.where(restart, eta / w_new, tau)
        sigma = torch.where(restart, eta * w_new, sigma)
    xr2 = torch.where(restart, x2, xr)
    yr2 = torch.where(restart, y2, yr)
    # the residuals of the point carried forward
    rp = torch.where(adopt_avg, rp_a, rp_c)
    rd = torch.where(adopt_avg, rd_a, rd_c)
    gp = torch.where(adopt_avg, gp_a, gp_c)
    stall = torch.where(err < err_prev * (1 - 1e-4), 0, stall + 1)
    return (x2, y2, sx2, sy2, cnt2, lre2, it + check_every, rp, rd, gp, stall, tau, sigma, xr2, yr2)


def pdhg_state_from_numpy(leaves: Mapping[str, object], device, dtype=torch.float32) -> tuple:
    """The PDHG state tuple from host arrays: a ``simplex_tpu.fo.pdhg``
    state's 15 leaves (x, y, sx, sy, cnt, lre, it, rp, rd, gp, stall, tau,
    sigma, xr, yr; a mapping by those names or a sequence in that order),
    so that both packages can run a window from identical inputs."""
    if not isinstance(leaves, Mapping):
        leaves = dict(zip(STATE_LEAVES, leaves))
    ints = ("cnt", "it", "stall")
    return tuple(
        torch.as_tensor(np.array(leaves[f]), device=device).to(
            torch.int32 if f in ints else dtype
        )
        for f in STATE_LEAVES
    )


def _initial_state(m, n, dtype, device, tau0, sigma0) -> tuple:
    def z(k):
        return torch.zeros(k, dtype=dtype, device=device)

    def i0():
        return torch.zeros((), dtype=torch.int32, device=device)

    inf = torch.full((), math.inf, dtype=dtype, device=device)
    return (
        z(n), z(m), z(n), z(m), i0(), inf, i0(), inf.clone(), inf.clone(), inf.clone(), i0(),
        tau0, sigma0, z(n), z(m),
    )


# ---- certificates (host, float64) -------------------------------------


def _host64(A, Ad):
    """The caller's A as a float64 host operator: the scipy CSC copy of a
    sparse one (``Ad``, the device matrix, carries it), else a dense array."""
    if isinstance(Ad, _sp.SparseA):
        return Ad.host
    return np.asarray(A.detach().cpu().numpy() if isinstance(A, torch.Tensor) else A, np.float64)


class _HostCert:
    """The products a certificate takes, on the whole A in float64 on the
    host (``simplex_tpu.fo.pdhg._cert_metrics`` split into its primal and
    dual halves)."""

    def __init__(self, A64, b, cmin, u):
        self.A64, self.b, self.cmin, self.finite, self.u = A64, b, cmin, np.isfinite(u), u

    def primal(self, xhat):
        """``(||A xhat||_inf, cmin.xhat)``."""
        viol_p = float(np.max(np.abs(self.A64 @ xhat))) if xhat.size else 0.0
        return viol_p, float(self.cmin @ xhat)

    def dual(self, yhat):
        """``(viol_d, obj_d)``: the positive part of A^T yhat on the
        unbounded columns, and b.yhat less the finite bounds' share."""
        pos = np.maximum(np.asarray(self.A64.T @ yhat).ravel(), 0)
        viol_d = float(np.max(np.where(self.finite, 0, pos))) if pos.size else 0.0
        return viol_d, float(self.b @ yhat - np.sum(np.where(self.finite, self.u, 0) * pos))

    def polish(self, d, fixed):
        return _polish_primal_ray(self.A64, d, fixed)


def _polish_primal_ray(A64, d, fixed, iters: int = 8):
    """Alternate projections of a candidate recession direction onto
    null(A) (normal equations, f64) and the recession cone (d >= 0, zero on
    the finite-u columns); dense A up to 2^24 entries, else as it is."""
    if hasattr(A64, "toarray"):
        if A64.shape[0] * A64.shape[1] > (1 << 24):
            return d
        A64 = A64.toarray()
    elif A64.size > (1 << 24):
        return d
    G = A64 @ A64.T + 1e-12 * np.eye(A64.shape[0])
    for _ in range(iters):
        try:
            w = np.linalg.solve(G, A64 @ d)
        except np.linalg.LinAlgError:
            return d
        d = d - A64.T @ w
        d = np.where(fixed, 0.0, np.maximum(d, 0.0))
        nd = float(np.max(np.abs(d)))
        if nd <= 0:
            return d
        d = d / nd
    return d


def _certify(ops, x, y, xr, yr, b_scale, c_scale, cert_tol, u):
    """PDLP's exit-time infeasibility detection from the divergent iterate
    ray: the epoch displacement and the normalized iterate, dual (Farkas)
    first, then primal (recession, polished in f64 when the raw candidate
    misses), with the products of ``ops`` (a :class:`_HostCert`, or the
    sharded solve's per-shard one). Returns ``(status, ray_primal,
    ray_dual)``, status None when nothing certifies."""
    free = ~np.isfinite(u)
    dx = np.where(free, np.maximum(x - xr, 0), 0)
    dy = y - yr

    def unit(v):
        nv = float(np.max(np.abs(v))) if v.size else 0.0
        return (v / nv, True) if nv > 0 else (v, False)

    for cand in (dy, y):
        ray, ok = unit(cand)
        if not ok:
            continue
        viol_d, obj_d = ops.dual(ray)
        if obj_d > 1e-8 * b_scale and viol_d <= cert_tol * obj_d:
            return SolveStatus.INFEASIBLE, None, ray

    def passes(ray):
        viol_p, obj_p = ops.primal(ray)
        return -obj_p > 1e-8 * c_scale and viol_p <= cert_tol * (-obj_p)

    for cand in (dx, np.where(free, np.maximum(x, 0), 0)):
        raw, ok = unit(cand)
        if not ok:
            continue
        if passes(raw):
            return SolveStatus.UNBOUNDED, raw, None
        polished = ops.polish(raw, ~free)
        if polished is not raw and passes(polished):
            return SolveStatus.UNBOUNDED, polished, None
    return None, None, None


def _as_device_A(A, dtype, device):
    if _sp.is_sparse(A):
        return _sp.as_sparse(A, dtype, device)
    if isinstance(A, torch.Tensor):
        return A.to(device=device, dtype=dtype)  # in place when it is there already
    return torch.as_tensor(np.asarray(A), device=device).to(dtype)


def solve_pdhg(
    A,
    b,
    c,
    *,
    u=None,
    tol: float = 1e-4,
    max_iter: int = 1_000_000,
    check_every: int = 128,
    dtype=torch.float32,
    adaptive_weight: bool = True,
    cert_tol: float = 1e-5,
    device="cuda",
) -> PDHGResult:
    """Solve  max c.x  s.t.  A x = b, 0 <= x (<= u)  to relative KKT
    tolerance ``tol`` by PDHG on ``device`` (default ``"cuda"``; there is
    no fallback to the CPU). Same arguments, defaults and result as
    ``simplex_tpu.fo.pdhg.solve_pdhg``: A dense, scipy.sparse or a
    :class:`~simplex_tpu_torch.sparse.SparseA`; ``u`` (n,) with +inf for
    an unbounded column; ``dtype`` float32 or float64 (``torch`` dtypes).

    ``status`` is OPTIMAL when the primal residual, the dual residual and
    the gap are all below ``tol``; INFEASIBLE / UNBOUNDED when the
    divergent iterate ray certifies it (the ray in ``ray_dual`` /
    ``ray_primal``); SINGULAR after 64 windows without progress; MAX_ITER
    when the budget ran out."""
    pin_full_fp32()
    device = torch.device(device)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"dtype must be torch.float32 or torch.float64, got {dtype}")
    b_np = np.asarray(b.cpu() if isinstance(b, torch.Tensor) else b, np.float64)
    c_np = np.asarray(c.cpu() if isinstance(c, torch.Tensor) else c, np.float64)
    Ad = _as_device_A(A, dtype, device)
    m, n = Ad.shape
    if b_np.shape != (m,) or c_np.shape != (n,):
        raise ValueError(f"shape mismatch: A {(m, n)}, b {b_np.shape}, c {c_np.shape}")
    u_np = np.full(n, np.inf) if u is None else np.asarray(
        u.cpu() if isinstance(u, torch.Tensor) else u, np.float64
    )
    if u is not None and np.any(u_np < 0):
        raise ValueError("negative upper bound (shift lowers to 0 first)")
    # the problem data in the solve's dtype (minimization form)
    b_t = torch.as_tensor(b_np, device=device).to(dtype)
    cmin = torch.as_tensor(-c_np, device=device).to(dtype)
    As, dr, dc, bs, cs, tau0, sigma0, b_scale, c_scale = _pdhg_setup(Ad, b_t, cmin, dtype)
    us = torch.as_tensor(u_np, device=device).to(dtype) * dc
    state = _initial_state(m, n, dtype, device, tau0, sigma0)
    it = stall = 0
    rp = rd = gp = math.inf
    while not (max(rp, rd, gp) < tol or it >= max_iter or stall >= STALL_WINDOWS):
        state = _pdhg_window(
            As, bs, cs, dr, dc, b_scale, c_scale, us, state, float(tol), int(check_every),
            bool(adaptive_weight),
        )
        # the window's one read
        vals = torch.stack([state[7].double(), state[8].double(), state[9].double(),
                            state[6].double(), state[10].double()]).tolist()
        rp, rd, gp = vals[0], vals[1], vals[2]
        it, stall = int(vals[3]), int(vals[4])
    x = (state[0] / dc).double().cpu().numpy()
    y = (state[1] / dr).double().cpu().numpy()
    ok = max(rp, rd, gp) < tol
    ray_p = ray_d = None
    if ok:
        status = SolveStatus.OPTIMAL
    else:
        xr = (state[13] / dc).double().cpu().numpy()
        yr = (state[14] / dr).double().cpu().numpy()
        ops = _HostCert(_host64(A, Ad), b_t.double().cpu().numpy(), cmin.double().cpu().numpy(), u_np)
        cert, ray_p, ray_d = _certify(ops, x, y, xr, yr, float(b_scale), float(c_scale), cert_tol, u_np)
        if cert is not None:
            status = cert
        elif stall >= STALL_WINDOWS:
            status = SolveStatus.SINGULAR
        else:
            status = SolveStatus.MAX_ITER
    return PDHGResult(
        z=float(c_np @ x),
        x=x,
        y=-y,  # the maximization dual's sign
        status=status,
        iters=it,
        primal_res=rp,
        dual_res=rd,
        gap=gp,
        ray_primal=ray_p,
        ray_dual=ray_d,
    )
