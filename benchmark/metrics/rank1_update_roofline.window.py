"""``rank1_update``'s share of its roofline in the steady window: B_inv
read and written once (frozen bytes) over the HBM peak, against the traced
device time a call."""

from benchmark.roofline import rank1_update
from benchmark.trace import roofline_share


def read(ctx):
    size = 8 if ctx["cell"].config["dtype"] == "float64" else 4
    return roofline_share(
        ctx, "rank1_update", lambda name: "rank1_kernel" in name,
        lambda s: rank1_update.nbytes(s["rows"], s["rows"], size),
        lambda s: rank1_update.flops(s["rows"], s["rows"]),
    )
