"""The ftran GEMV's share of its roofline in the steady window: B_inv read
once, the column in and out (frozen bytes, ``roofline/ftran_gemv.py``) over
the HBM peak, against the traced device time a record of cuBLAS's GEMV
kernel, the mean over the ranks. A GEMV kernel is one whose own name holds
"gemv" (``gemv2T_kernel_val`` in float32, ``internal::gemvx::kernel`` in
float64): the ftran's product is the only GEMV of the default step, and the
dot product's kernels, which name GEMV types among their template arguments
and parameters, are not. None where the stretch ran no GEMV."""

import re

from benchmark import roofline
from benchmark.roofline import ftran_gemv
from benchmark.trace import rank_summaries


def _is_gemv(name: str) -> bool:
    """Whether the kernel's own name, its template arguments and its
    parameters taken out, holds "gemv"."""
    while True:
        bare = re.sub(r"<[^<>]*>", "", name)
        if bare == name:
            break
        name = bare
    return "gemv" in name.replace("(anonymous namespace)", "").split("(", 1)[0].lower()


def read(ctx):
    size = 8 if ctx["cell"].config["dtype"] == "float64" else 4
    peak = roofline.peaks()["fp64_flops_s" if size == 8 else "fp32_flops_s"]
    shares = []
    for s in rank_summaries(ctx["trace"]):
        ops = [v for name, v in s["ops"].items() if _is_gemv(name)]
        calls, secs = sum(v["count"] for v in ops), sum(v["s"] for v in ops)
        if calls <= 0 or secs <= 0:
            continue
        bound = roofline.bound_s(ftran_gemv.nbytes(s["rows"], size), ftran_gemv.flops(s["rows"]), peak)
        shares.append(100.0 * bound / (secs / calls))
    return sum(shares) / len(shares) if shares else None
