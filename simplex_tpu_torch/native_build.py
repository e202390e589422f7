"""Build the port's two C++ helpers with g++ at first use.

``io/cpp/fast_loader.cpp`` (the text loader) and
``oracle/cpp/simplex_oracle.cpp`` (the f64 oracle) have plain C interfaces
and are loaded with ``ctypes``, as the CUDA kernels are
(:mod:`simplex_tpu_torch.kernels._build`): each compiles once into
``build/native/`` beside the package, under a name that hashes its source
and flags, so an edited source never loads a stale library; nothing is
written into the package directory. Builds by concurrent processes do not
collide: each links to a file of its own and renames it into place.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def compiler() -> str:
    """The path of g++; raises OSError when there is none."""
    found = shutil.which("g++")
    if found is None:
        raise OSError("g++ not found on PATH: the native helpers cannot be built")
    return found


def library_path(src: Path) -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(Path(src).read_bytes())
    return BUILD_DIR / f"lib{Path(src).stem}_{h.hexdigest()[:16]}.so"


def build(src: Path) -> Path:
    """Compile ``src`` into a shared library unless this exact build
    exists; returns its path. Raises OSError (no compiler) or
    subprocess.CalledProcessError (the compiler failed)."""
    out = library_path(src)
    if out.exists():
        return out
    gxx = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.name}.{os.getpid()}.tmp"
    try:
        subprocess.run([gxx, *GXX_FLAGS, "-o", str(tmp), str(src)], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out
