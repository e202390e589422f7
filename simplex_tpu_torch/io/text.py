"""The reference text format: ``m n``, then A (m x n), b (m), c (n),
whitespace separated; and the thesis archive's order (``M N``, then c, b,
A). A numpy-only copy of ``simplex_tpu.io.text``'s readers and writer:
that package imports jax, this one must not.
"""

from __future__ import annotations

import io
import os
from typing import Tuple

import numpy as np


def loads_lp(text: str, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse the text format from a string. Returns (A, b, c)."""
    tokens = text.split()
    if len(tokens) < 2:
        raise ValueError("LP text: missing header 'm n'")
    m, n = int(tokens[0]), int(tokens[1])
    if m > n:
        raise ValueError(f"LP text: m > n ({m} > {n})")
    need = 2 + m * n + m + n
    if len(tokens) < need:
        raise ValueError(f"LP text: expected {need} tokens, got {len(tokens)}")
    vals = np.asarray(tokens[2:need], dtype=np.float64)
    A = vals[: m * n].reshape(m, n).astype(dtype)
    b = vals[m * n : m * n + m].astype(dtype)
    c = vals[m * n + m :].astype(dtype)
    return A, b, c


def load_lp(path: str | os.PathLike, dtype=np.float32):
    """Load (A, b, c) from a file in the text format. Prose after the numbers
    (the sample file's explanation block) is ignored."""
    with open(path, "r") as f:
        tokens = f.read().split()
    if len(tokens) < 2:
        raise ValueError(f"{path}: missing header")
    m, n = int(tokens[0]), int(tokens[1])
    need = 2 + m * n + m + n
    return loads_lp(" ".join(tokens[:need]), dtype=dtype)


def dumps_lp(A: np.ndarray, b: np.ndarray, c: np.ndarray) -> str:
    """(A, b, c) in the text format, each value as Python's repr of it."""
    m, n = A.shape
    buf = io.StringIO()
    buf.write(f"{m} {n}\n")
    for row in np.asarray(A):
        buf.write(" ".join(repr(float(v)) for v in row))
        buf.write("\n")
    buf.write(" ".join(repr(float(v)) for v in np.asarray(b)))
    buf.write("\n")
    buf.write(" ".join(repr(float(v)) for v in np.asarray(c)))
    buf.write("\n")
    return buf.getvalue()


def save_lp(path: str | os.PathLike, A, b, c) -> None:
    with open(path, "w") as f:
        f.write(dumps_lp(np.asarray(A), np.asarray(b), np.asarray(c)))


def loads_lp_thesis(text: str, dtype=np.float32):
    """Parse the thesis archive's field order: ``M N``, then c (n), b (m),
    A (m x n). Returns (A, b, c)."""
    tokens = text.split()
    if len(tokens) < 2:
        raise ValueError("LP text (thesis order): missing header 'M N'")
    m, n = int(tokens[0]), int(tokens[1])
    need = 2 + n + m + m * n
    if len(tokens) < need:
        raise ValueError(f"LP text (thesis order): expected {need} tokens, got {len(tokens)}")
    vals = np.asarray(tokens[2:need], dtype=np.float64)
    c = vals[:n].astype(dtype)
    b = vals[n : n + m].astype(dtype)
    A = vals[n + m :].reshape(m, n).astype(dtype)
    return A, b, c


def load_lp_thesis(path: str | os.PathLike, dtype=np.float32):
    """Load (A, b, c) from a file in the thesis archive's field order."""
    with open(path, "r") as f:
        return loads_lp_thesis(f.read(), dtype=dtype)
