"""Build and load the Hopper kernels.

The CUDA sources in ``simplex_tpu_torch/csrc`` compile with nvcc (one
process per source, side by side) into one shared library with a plain C
interface, loaded through ``ctypes``: no PyTorch headers, so the build takes
seconds. It happens at first use, into
``build/kernels/`` beside the package, under a name that hashes the sources
and flags (the shared header included), so an edited source never loads a
stale library.

Environment: ``CUDA_HOME`` (default ``/usr/local/cuda``) locates nvcc when
it is not on ``PATH``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

SOURCES = (
    "pricing_scan.cu", "ratio_argmin.cu", "ratio_eta.cu", "rank1_update.cu",
    "batch_pricing.cu", "batch_tail.cu", "batch_rank1.cu", "dmma_probe.cu",
)
# included by the sources: part of the build's name, so an edited header
# rebuilds every object
HEADERS = ("ratio_cluster.cuh",)
CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
# Every kernel takes a dtype code first (0 float32, 1 float64; the pricing
# kernels after a layout: A's code, then the vectors') and its tolerances as
# doubles, which it rounds to its element type.
_SIGNATURES = {
    "simplex_pricing_scan": (
        _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _L, _D, _I, _I, _I, _P, _I, _I,
        _P, _P, _P, _P, _P, _P, _P,
    ),
    "simplex_ratio_argmin": (_I, _P, _P, _P, _P, _I, _I, _D, _I, _P, _P, _P, _P),
    "simplex_ratio_eta": (_I, _P, _P, _P, _P, _I, _I, _D, _D, _I, _I, _P, _P, _P, _P, _P),
    "simplex_pivot_tail": (
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,  # dtype, vectors, B_inv, U, R, npend
        _P, _P, _P, _P, _P, _P, _P,  # min_e, e_p, c_p, p, iters, degen, npend_in
        _I, _D, _D, _D, _D, _I, _I, _I, _I, _I, _I, _I,  # m .. cluster_blocks
        _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs, stream
    ),
    "simplex_rank1_update": (_I, _P, _P, _P, _I, _I, _I, _P),
    "simplex_batch_pricing": (
        _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _I, _I,  # layout .. words
        _P, _P, _P, _P,  # mask, recs, p, min_e
        _I, _I, _P, _I,  # win, win_s, win_seg, a_shared
        _P, _I, _P,  # group, group_tiles, stream
    ),
    "simplex_batch_pricing_groups": (_P, _I, _I, _I, _P, _P),
    "simplex_batch_pricing_record_bytes": (_I,),
    "simplex_batch_tail": (
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,  # dtype, vectors, B_inv, U, R, npend, L
        _P, _P, _P, _P, _P, _P, _P, _P,  # min_e .. active
        _I, _I, _D, _D, _D, _D, _I, _I, _I, _I, _I, _I,  # batch .. st_singular
        _I, _I, _I,  # threads, rows_per_lane, vec
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,  # outputs (theta_q apart), stream
    ),
    "simplex_batch_rank1": (_I, _P, _P, _P, _P, _I, _I, _I, _P),
    "simplex_dmma_probe": (_I, _P, _P, _P, _P, _P, _I, _I, _P),
    "simplex_dmma_probe_shapes": (),
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (not on PATH, nor under $CUDA_HOME/bin): the Hopper "
        "kernels cannot be built"
    )


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsimplex_kernels_{h.hexdigest()[:16]}.so"


def build(verbose: bool = False) -> Tuple[Path, str]:
    """Compile the kernels unless this exact build exists: one nvcc per
    source, all started together, then one link. Returns the library's path
    and the compilers' messages (with ``verbose``, ptxas's register and
    shared-memory report for each kernel)."""
    out = library_path()
    if out.exists() and not verbose:
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    flags = [f for f in NVCC_FLAGS if f != "-shared"]
    if verbose:
        flags += ["-Xptxas", "-v"]
    objs = [BUILD_DIR / f"{tag}.{Path(s).stem}.o" for s in SOURCES]
    procs = [
        subprocess.Popen(
            [nvcc, *flags, "-c", "-o", str(obj), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(SOURCES, objs)
    ]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        for src, proc, log in zip(SOURCES, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src} with code {proc.returncode}:\n{log}")
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *map(str, objs)], capture_output=True, text=True
        )
        if link.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to link with code {link.returncode}:\n{link.stdout}{link.stderr}"
            )
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, "".join(logs) + link.stdout + link.stderr


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        lib.simplex_cuda_error_string.argtypes = [ctypes.c_int]
        lib.simplex_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        msg = load_library().simplex_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed with error {err} ({msg})")
