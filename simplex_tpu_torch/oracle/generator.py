"""Test and benchmark instances (numpy only).

Copies of ``simplex_tpu.oracle.generator``'s canonical-form instances, so
that a machine without jax builds the same LPs from the same seeds. Each
has a trailing identity slack block, the starting basis of ``solve``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def random_dense_lp(
    m: int,
    n: int,
    seed: int = 0,
    dtype=np.float32,
    degenerate: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, b, c) with A (m, n) whose last m columns are I; feasible at the
    slack basis (b > 0) and bounded (positive structural columns).

    ``n`` counts all columns including the m slacks.
    """
    if n <= m:
        raise ValueError(f"need n > m, got m={m} n={n}")
    rng = np.random.default_rng(seed)
    k = n - m
    A_raw = rng.uniform(0.1, 1.0, size=(m, k))
    A = np.concatenate([A_raw, np.eye(m)], axis=1).astype(dtype)
    b = rng.uniform(1.0, 2.0, size=m).astype(dtype)
    c = np.concatenate(
        [rng.uniform(0.1, 1.0, size=k), np.zeros(m)]
    ).astype(dtype)
    if degenerate:
        b[: m // 2] = b[0]
        c[: max(1, k // 4)] = c[0]
    return A, b, c


def klee_minty_lp(n: int):
    """Klee-Minty cube in canonical slack form (maximize). Dantzig pricing
    visits all 2^n - 1 improving vertices; the optimum is 5^n."""
    A = np.zeros((n, 2 * n))
    b = np.zeros(n)
    c = np.zeros(2 * n)
    for i in range(n):
        for j in range(i):
            A[i, j] = 2.0 ** (i - j + 1)
        A[i, i] = 1.0
        A[i, n + i] = 1.0  # slack
        b[i] = 5.0 ** (i + 1)
        c[i] = 2.0 ** (n - 1 - i)
    return A, b, c


def degenerate_streak_lp(m: int = 24, n: int = 60, seed: int = 5):
    """Canonical LP whose slack start sits on a highly degenerate vertex
    (every fourth rhs entry is zero): the walk runs through streaks of
    zero-theta pivots, which arms the rhs perturbation."""
    rng = np.random.default_rng(seed)
    k = n - m
    G = rng.uniform(0.1, 1.0, (m, k)) * (rng.random((m, k)) < 0.3)
    A = np.concatenate([G, np.eye(m)], axis=1).astype(np.float32)
    b = rng.uniform(1.0, 2.0, m).astype(np.float32)
    b[::4] = 0.0
    c = np.concatenate([rng.uniform(0.5, 2.0, k), np.zeros(m)]).astype(
        np.float32
    )
    return A, b, c
