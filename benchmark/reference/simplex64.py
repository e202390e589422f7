"""Float64 reference of the revised simplex on a dense canonical LP.

Every quantity is worked out again from A, b, c and a basis (a list of m
column indices) by a float64 LU of the basis matrix: x_b = B^-1 b,
y = c_B B^-1, the reduced costs d = y A - c, the entering column's
ftran alpha = B^-1 A_p and the steepest-edge norms 1 + |B^-1 A_j|^2. A is
read through a column source (``make(lo, hi)`` gives columns [lo, hi) as
a tensor on the device), in blocks of ``block`` columns, so that the whole A
never has to be held in float64.

The numbers it gives are the ones the benchmark compares (``benchmark/
check.py``); each is a widest gap, 0 for an exact answer:

  pricing_gap   how far the entering column lies above the best by the rule
                the cell runs, over max(1, |c|_max): Dantzig d_p - d_min;
                steepest edge the smaller of that and t_p - t_min with
                t = d / sqrt(gamma) (a stale steepest-edge pick falls back
                to the Dantzig pick)
  ratio_gap     the primal infeasibility the step's leaving row creates:
                max over alpha_i > pivot_tol of theta_q alpha_i - x_i, over
                max(1, |x|_max) (the Harris test allows feas_tol)
  xb_err        |x_b - B^-1 b|_max over max(1, |B^-1 b|_max)
  y_err         |y - c_B B^-1|_max over max(1, |y|_max)
  binv_err      |B_inv B - I|_max
  z_err         |z - c_B x_b| over max(1, |z|)
  primal_infeas max(0, -min x_b) of the answer's own x_b
  dual_infeas   max(0, -min_j (y A - c)_j) over the nonbasic columns, from
                the answer's own y, over max(1, |c|_max)
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64


class ColumnSource:
    """Columns of A on ``device``: ``make(lo, hi)`` returns A[:, lo:hi]."""

    def __init__(self, make, m: int, n: int, block: int, device):
        self.make, self.m, self.n, self.block, self.device = make, m, n, block, torch.device(device)

    def blocks(self):
        for lo in range(0, self.n, self.block):
            hi = min(self.n, lo + self.block)
            yield lo, hi, self.make(lo, hi)

    def gather(self, idx: torch.Tensor) -> torch.Tensor:
        """A[:, idx] in float64."""
        idx = idx.to(self.device, torch.int64)
        out = torch.empty((self.m, idx.numel()), dtype=F64, device=self.device)
        for lo, hi, blk in self.blocks():
            sel = ((idx >= lo) & (idx < hi)).nonzero().view(-1)
            if sel.numel():
                out[:, sel] = blk.index_select(1, idx[sel] - lo).to(F64)
        return out


def tensor_source(A: torch.Tensor, block: int = 8192) -> ColumnSource:
    return ColumnSource(lambda lo, hi: A[:, lo:hi], A.shape[0], A.shape[1], block, A.device)


class Basis:
    """The float64 LU of A[:, basis] and what follows from it."""

    def __init__(self, src: ColumnSource, b: torch.Tensor, c: torch.Tensor, basis: torch.Tensor):
        self.src = src
        self.basis = basis.to(src.device, torch.int64)
        self.B = src.gather(self.basis)
        self.lu, self.piv = torch.linalg.lu_factor(self.B)
        self.b = b.to(src.device, F64)
        self.c = c.to(src.device, F64)
        self.x = self.solve(self.b)
        self.y = self.solve_t(self.c.index_select(0, self.basis))

    def solve(self, r: torch.Tensor) -> torch.Tensor:
        return torch.linalg.lu_solve(self.lu, self.piv, r.to(F64).reshape(self.B.shape[0], -1)).reshape(r.shape)

    def solve_t(self, r: torch.Tensor) -> torch.Tensor:
        return torch.linalg.lu_solve(self.lu, self.piv, r.to(F64).view(-1, 1), adjoint=True).view(-1)

    def inverse(self) -> torch.Tensor:
        return self.solve(torch.eye(self.B.shape[0], dtype=F64, device=self.B.device))

    def reduced_costs(self, y=None) -> torch.Tensor:
        """d = y A - c (``y`` default: the reference's), +inf on the basis."""
        y = self.y if y is None else y.to(self.src.device, F64)
        d = torch.cat([y @ blk.to(F64) for _, _, blk in self.src.blocks()]) - self.c
        return d.index_fill(0, self.basis, math.inf)

    def steepest_norms(self) -> torch.Tensor:
        """gamma_j = 1 + |B^-1 A_j|^2 for every column."""
        out = []
        for _, _, blk in self.src.blocks():
            T = self.solve(blk.to(F64))
            out.append(1 + (T * T).sum(0))
        return torch.cat(out)

    def column(self, p: int) -> torch.Tensor:
        return self.src.gather(torch.tensor([p], device=self.src.device)).view(-1)


def _scaled(v, scale) -> float:
    return float(v) / max(1.0, float(scale))


def entering_leaving(basis0: torch.Tensor, basis1: torch.Tensor):
    """(p, q) of the pivot that took basis0 to basis1, or None when the
    step changed no position (a terminal step) or more than one."""
    diff = (basis0.to(torch.int64) != basis1.to(torch.int64)).nonzero().view(-1)
    if diff.numel() != 1:
        return None
    q = int(diff[0])
    return int(basis1[q]), q


def dantzig_gap(d: torch.Tensor, p: int, scale: float = 1.0) -> float:
    dmin = float(d.min())
    if not dmin < 0:
        return math.inf  # a pivot from an optimal basis
    return _scaled(float(d[p]) - dmin, scale)


def steepest_gap(d: torch.Tensor, gamma: torch.Tensor, p: int, scale: float = 1.0) -> float:
    t = d / gamma.sqrt()
    return _scaled(float(t[p]) - float(t.min()), scale)


def pricing_gap(ref: Basis, p: int, rule: str, d=None, gamma=None) -> float:
    d = ref.reduced_costs() if d is None else d
    scale = float(ref.c.abs().max())
    gap = dantzig_gap(d, p, scale)
    if rule == "steepest":
        gamma = ref.steepest_norms() if gamma is None else gamma
        gap = min(gap, steepest_gap(d, gamma, p, scale))
    return gap


def ratio_gap(ref: Basis, alpha: torch.Tensor, q: int, pivot_tol: float) -> float:
    x = ref.x
    if not float(alpha[q]) > pivot_tol:
        return math.inf
    theta = float(x[q]) / float(alpha[q])
    elig = alpha > pivot_tol
    viol = torch.where(elig, theta * alpha - x, -math.inf).max()
    return _scaled(max(0.0, float(viol)), x.abs().max())


def xb_err(ref: Basis, x_b: torch.Tensor) -> float:
    return _scaled((x_b.to(ref.x) - ref.x).abs().max(), ref.x.abs().max())


def y_err(ref: Basis, y: torch.Tensor) -> float:
    return _scaled((y.to(ref.y) - ref.y).abs().max(), ref.y.abs().max())


def binv_err(ref: Basis, B_inv: torch.Tensor, rows: int = 4096) -> float:
    """|B_inv B - I|_max, in blocks of ``rows`` rows of B_inv."""
    m = ref.B.shape[0]
    worst = 0.0
    for r0 in range(0, m, rows):
        P = B_inv[r0 : r0 + rows].to(F64) @ ref.B
        P.diagonal(offset=r0).sub_(1)  # the identity's rows r0..
        worst = max(worst, float(P.abs().max()))
        del P
    return worst


def z_err(ref: Basis, z: float) -> float:
    zr = float(ref.c.index_select(0, ref.basis) @ ref.x)
    return _scaled(abs(float(z) - zr), abs(zr))


def primal_infeas(x_b: torch.Tensor) -> float:
    return max(0.0, -float(x_b.min()))


def dual_infeas(ref: Basis, y: torch.Tensor) -> float:
    d = ref.reduced_costs(y)
    return _scaled(max(0.0, -float(d.min())), ref.c.abs().max())
