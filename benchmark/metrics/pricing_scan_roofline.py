"""``pricing_scan``'s share of its roofline: the frozen bytes of one call
(A's columns that the card holds, once; y, c, the basis) over the HBM
peak, against the traced device time a call of its kernels."""

from benchmark.roofline import pricing_scan
from benchmark.trace import roofline_share


def _is_pricing(name: str) -> bool:
    return "pricing_" in name and "batch" not in name


def read(ctx):
    size = 8 if ctx["cell"].config["dtype"] == "float64" else 4
    return roofline_share(
        ctx, "pricing_scan", _is_pricing,
        lambda s: pricing_scan.nbytes(s["rows"], s["cols"], size),
        lambda s: pricing_scan.flops(s["rows"], s["cols"]),
    )
