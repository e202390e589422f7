"""Dense canonical-form LPs made on the device from a seed.

The recipe of the upstream project's canonical LPs (a trailing identity
slack block, the slack basis feasible) and of
``simplex_tpu_torch.oracle.generator.random_dense_lp``:

    A = [U(0.1, 1) | I],  b ~ U(1, 2),  c = [U(0.1, 1) | 0]

A's structural columns are made in blocks of ``block`` columns, block j
from a ``torch.Generator`` of its own seeded from (seed, j), so that any
range of columns can be made alone: a rank of a column-sharded solve makes
its own columns, and the reference makes again whatever columns it needs.
b and c have generators of their own. The values differ from
``random_dense_lp``'s (numpy's stream), the distribution is the same.
"""

from __future__ import annotations

import torch

_MIX = 0x9E3779B97F4A7C15
_MASK = (1 << 63) - 1


def stream_seed(seed: int, tag: int) -> int:
    """A 63-bit generator seed for stream ``tag`` of run seed ``seed``."""
    return ((int(seed) * 1_000_003 + (tag + 1) * _MIX) ^ (tag << 17)) & _MASK


def _uniform(shape, lo: float, hi: float, seed: int, device, dtype) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    out = torch.rand(shape, generator=g, device=device, dtype=torch.float32)
    return out.mul_(hi - lo).add_(lo).to(dtype)


def rhs(m: int, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    return _uniform((m,), 1.0, 2.0, stream_seed(seed, -1), device, dtype)


def costs(m: int, n: int, seed: int, device, dtype=torch.float32) -> torch.Tensor:
    c = torch.zeros(n, dtype=dtype, device=device)
    c[: n - m] = _uniform((n - m,), 0.1, 1.0, stream_seed(seed, -2), device, dtype)
    return c


def columns(m: int, n: int, lo: int, hi: int, seed: int, block: int, device,
            dtype=torch.float32) -> torch.Tensor:
    """Columns [lo, hi) of A as one contiguous (m, hi - lo) tensor."""
    k = n - m
    out = torch.zeros((m, hi - lo), dtype=dtype, device=device)
    for j0 in range(lo - lo % block, min(hi, k), block):
        j1 = min(j0 + block, k)
        blk = _uniform((m, j1 - j0), 0.1, 1.0, stream_seed(seed, j0 // block), device, dtype)
        a, b = max(lo, j0), min(hi, j1)
        out[:, a - lo : b - lo] = blk[:, a - j0 : b - j0]
        del blk
    # the slack block: column k + i is e_i
    s0 = max(lo, k)
    if s0 < hi:
        rows = torch.arange(s0 - k, hi - k, device=device)
        out[rows, rows + k - lo] = 1
    return out


def dense_canonical(cfg: dict, seed: int, device, lo: int = 0, hi=None):
    """(A[:, lo:hi], b, c) of configuration ``cfg`` in its dtype."""
    m, n = cfg["m"], cfg["n"]
    dtype = getattr(torch, cfg["dtype"])
    hi = n if hi is None else hi
    A = columns(m, n, lo, hi, seed, cfg["column_block"], device, dtype)
    return A, rhs(m, seed, device, dtype), costs(m, n, seed, device, dtype)
