"""Dense inversion by Newton-Schulz iteration.

The counterpart of ``simplex_tpu.core.linalg.inverse_newton``: refine a
seed inverse (the solver's drifted product-form B_inv, which reaches the
fp floor in one or two iterations), or start from the Pan-Schreiber scaling
``X0 = B.T / (||B||_1 ||B||_inf)``, which contracts for any nonsingular B.
Each iteration is two GEMMs in full fp32 (TF32 off). The stopping test
reads the residual on the host once per iteration: refactorization runs
only at verify rounds and every ``refactor_every`` pivots.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _residual(Y: torch.Tensor, eye: torch.Tensor) -> torch.Tensor:
    return (Y - eye).abs().max()


def inverse_newton(
    B: torch.Tensor, seed: Optional[torch.Tensor] = None, max_iter: int = 100
) -> Tuple[torch.Tensor, float]:
    """Return ``(X ~= inv(B), ||I - B X||_max)``.

    A seed whose residual is not below 0.5 (or is not finite) is replaced
    by the Pan-Schreiber start. Iterates while the residual is above
    16 eps and still falling, at most ``max_iter`` times, and returns the
    best iterate. A singular B is reported through the residual, not raised.
    """
    m = B.shape[0]
    eye = torch.eye(m, dtype=B.dtype, device=B.device)
    tiny = torch.finfo(B.dtype).tiny
    floor = 16 * torch.finfo(B.dtype).eps
    absB = B.abs()
    scale = torch.clamp_min(absB.sum(0).max() * absB.sum(1).max(), tiny)
    del absB

    X = None
    if seed is not None:
        Y = B @ seed
        resid = _residual(Y, eye).item()
        if math.isfinite(resid) and resid < 0.5:
            X = seed
    if X is None:
        X = (B.T / scale).contiguous()
        Y = B @ X
        resid = _residual(Y, eye).item()

    X_prev, prev, it = X, math.inf, 0
    while resid > floor and resid < prev and it < max_iter:
        X1 = X @ (2 * eye - Y)
        Y = B @ X1
        X_prev, prev = X, resid
        X, resid = X1, _residual(Y, eye).item()
        it += 1
    if resid >= prev:
        return X_prev, prev
    return X, resid


def inverse_newton_batched(
    B: torch.Tensor, seed: torch.Tensor, max_iter: int = 100
) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`inverse_newton` for a stack of matrices B (k, m, m), each with
    its own seed, start, stopping test and best iterate; every product is
    one batched GEMM in full fp32. Returns ``(X, residuals (k,))``. The
    residuals are read on the host once per iteration (whether any matrix
    still iterates)."""
    k, m, _ = B.shape
    eye = torch.eye(m, dtype=B.dtype, device=B.device).expand(k, m, m)
    tiny = torch.finfo(B.dtype).tiny
    floor = 16 * torch.finfo(B.dtype).eps

    def resid(Y):
        return (Y - eye).abs().amax((1, 2))

    absB = B.abs()
    scale = torch.clamp_min(absB.sum(1).amax(1) * absB.sum(2).amax(1), tiny)
    del absB
    Yd = torch.bmm(B, seed)
    rd = resid(Yd)
    use_seed = torch.isfinite(rd) & (rd < 0.5)
    Xs = B.transpose(1, 2) / scale[:, None, None]
    X = torch.where(use_seed[:, None, None], seed, Xs)
    Y = torch.where(use_seed[:, None, None], Yd, torch.bmm(B, Xs))
    r = torch.where(use_seed, rd, resid(Y))
    prev = torch.full_like(r, math.inf)
    best_X, best_r = X, r
    go = (r > floor) & (r < prev)
    for _ in range(max_iter):
        if not bool(go.any()):
            break
        X1 = torch.bmm(X, 2 * eye - Y)
        Y1 = torch.bmm(B, X1)
        r1 = resid(Y1)
        # a matrix that stopped keeps its iterate; one that goes on takes the
        # step, and keeps the better of the two as its answer
        gm = go[:, None, None]
        better = go & (r1 < r)
        best_X = torch.where(better[:, None, None], X1, torch.where(gm, X, best_X))
        best_r = torch.where(better, r1, torch.where(go, r, best_r))
        X = torch.where(gm, X1, X)
        Y = torch.where(gm, Y1, Y)
        prev = torch.where(go, r, prev)
        r = torch.where(go, r1, r)
        go = go & (r > floor) & (r < prev)
    return best_X.contiguous(), best_r
