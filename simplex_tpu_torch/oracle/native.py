"""ctypes binding for the native f64 oracle (``oracle/cpp/simplex_oracle.cpp``).

The port's counterpart of ``simplex_tpu.oracle.native``: an independent,
from-scratch double-precision dense simplex (Bland anti-cycling, periodic
Gauss-Jordan refactorization) on the host, the stand-in for the
reference's GLPK oracle. It builds with g++ at first use into
``build/native/`` (:mod:`simplex_tpu_torch.native_build`); without a
compiler :func:`solve_native` raises, as the JAX module does.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from simplex_tpu_torch import native_build
from simplex_tpu_torch.oracle.reference import OracleResult
from simplex_tpu_torch.status import SolveStatus

SRC = Path(__file__).resolve().parent / "cpp" / "simplex_oracle.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

# the library's return codes
_STATUS_MAP = {
    1: SolveStatus.OPTIMAL,
    2: SolveStatus.UNBOUNDED,
    3: SolveStatus.MAX_ITER,
    4: SolveStatus.SINGULAR,
}


def build() -> str:
    """Compile the oracle unless this exact build exists; returns the .so
    path."""
    return str(native_build.build(SRC))


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            f64 = ctypes.POINTER(ctypes.c_double)
            i32 = ctypes.POINTER(ctypes.c_int32)
            fn = lib.simplex_solve_f64
            fn.restype = ctypes.c_int32
            # A, b, c, m, n, max_iter, basis (in / out), z, x, iters (out)
            fn.argtypes = [f64, f64, f64, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
                           i32, f64, f64, i32]
            _lib = lib
    return _lib


def solve_native(A, b, c, basis0=None, max_iter: int = 0) -> OracleResult:
    """Solve max c.x s.t. Ax = b, x >= 0 with the native f64 oracle, from
    ``basis0`` (default: the trailing slack basis)."""
    lib = _load()
    A = np.ascontiguousarray(A, np.float64)
    b = np.ascontiguousarray(b, np.float64)
    c = np.ascontiguousarray(c, np.float64)
    m, n = A.shape
    if basis0 is None:
        basis = np.arange(n - m, n, dtype=np.int32)
    else:
        basis = np.ascontiguousarray(basis0, np.int32).copy()
    if max_iter <= 0:
        max_iter = 50 * (m + n)
    z = ctypes.c_double(0.0)
    x = np.zeros(n, np.float64)
    iters = ctypes.c_int32(0)

    def ptr(arr, typ):
        return arr.ctypes.data_as(ctypes.POINTER(typ))

    code = lib.simplex_solve_f64(
        ptr(A, ctypes.c_double), ptr(b, ctypes.c_double), ptr(c, ctypes.c_double),
        m, n, max_iter, ptr(basis, ctypes.c_int32), ctypes.byref(z),
        ptr(x, ctypes.c_double), ctypes.byref(iters),
    )
    status = _STATUS_MAP.get(int(code), SolveStatus.SINGULAR)
    if status == SolveStatus.OPTIMAL:
        return OracleResult(z=float(z.value), x=x, status=status)
    return OracleResult(z=None, x=None, status=status)
