"""ctypes binding for the native text loader (``io/cpp/fast_loader.cpp``).

The port's counterpart of ``simplex_tpu.io.native``: ``load_lp_fast`` is a
drop-in for :func:`simplex_tpu_torch.io.text.load_lp` that mmaps the file
and parses it with strtof straight into numpy buffers; ``save_lp_fast``
writes the format. The library builds with g++ at first use into
``build/native/`` (:mod:`simplex_tpu_torch.native_build`). Where it cannot
be built (no compiler), both fall back to the Python readers and writers,
as the JAX module does, and say so once in the log. No device is involved.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

from simplex_tpu_torch import native_build
from simplex_tpu_torch.logging import get_logger

SRC = Path(__file__).resolve().parent / "cpp" / "fast_loader.cpp"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, or None when it cannot be built."""
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        try:
            lib = ctypes.CDLL(str(native_build.build(SRC)))
        except (subprocess.CalledProcessError, OSError) as exc:
            _build_failed = True
            get_logger("io").warning(
                "native text loader unavailable (%s); using the Python parser", exc
            )
            return None
        f32 = ctypes.POINTER(ctypes.c_float)
        lib.lp_text_header.restype = ctypes.c_int32
        lib.lp_text_header.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        for fn in (lib.lp_text_load_f32, lib.lp_text_save_f32):
            fn.restype = ctypes.c_int32
            fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, f32, f32, f32]
        _lib = lib
    return _lib


def _fptr(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def load_lp_fast(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Native load of the reference text format (fp32): ``(A, b, c)``. Falls
    back to the Python parser when the native library cannot be built."""
    lib = _load()
    path = os.fspath(path)
    if lib is None:
        from simplex_tpu_torch.io.text import load_lp

        return load_lp(path)
    m64, n64 = ctypes.c_int64(0), ctypes.c_int64(0)
    rc = lib.lp_text_header(path.encode(), ctypes.byref(m64), ctypes.byref(n64))
    if rc != 0:
        raise ValueError(f"{path}: bad LP text header (native rc={rc})")
    m, n = m64.value, n64.value
    A = np.empty((m, n), np.float32)
    b = np.empty(m, np.float32)
    c = np.empty(n, np.float32)
    rc = lib.lp_text_load_f32(path.encode(), m, n, _fptr(A), _fptr(b), _fptr(c))
    if rc != 0:
        raise ValueError(f"{path}: LP text parse failed (native rc={rc})")
    return A, b, c


def save_lp_fast(path, A, b, c) -> None:
    """Write (A, b, c) in the text format (fp32), natively where the library
    builds, else with the Python writer."""
    lib = _load()
    A = np.ascontiguousarray(A, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    c = np.ascontiguousarray(c, np.float32)
    if lib is None:
        from simplex_tpu_torch.io.text import save_lp

        save_lp(path, A, b, c)
        return
    m, n = A.shape
    rc = lib.lp_text_save_f32(os.fspath(path).encode(), m, n, _fptr(A), _fptr(b), _fptr(c))
    if rc != 0:
        raise OSError(f"{path}: native save failed (rc={rc})")
