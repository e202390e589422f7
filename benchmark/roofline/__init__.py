"""The yardstick of the kernels' roofline shares.

``peaks.json`` holds the card's published peaks; each kernel's module here
(``roofline/<kernel>.py``) holds the bytes and operations one call must
move at a shape, frozen from the arithmetic of ``chip_smoke.py`` so that a
change to a kernel cannot move its yardstick: each input read once, each
output written once. :func:`bound_s` is the least time the card could take.
"""

from __future__ import annotations

import importlib
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def peaks() -> dict:
    return json.loads((HERE / "peaks.json").read_text())


def kernel(name: str):
    """The byte and operation counts of kernel ``name``."""
    return importlib.import_module(f"benchmark.roofline.{name}")


def bound_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The larger of bytes over the HBM peak and operations over the peak."""
    return max(nbytes / peaks()["hbm_bytes_s"], flops / peak_flops)
