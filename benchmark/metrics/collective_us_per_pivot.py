"""The NCCL kernels' device time a pivot (the collectives, waits for the
other ranks included), on the rank where it is largest, as
``simplex_tpu_torch/dist/card_check.py`` reads it."""

from benchmark.trace import kernel_seconds, rank_summaries


def read(ctx):
    got = [1e6 * kernel_seconds(s, lambda n: "nccl" in n.lower()) / s["pivots"]
           for s in rank_summaries(ctx["trace"]) if s["pivots"] > 0]
    return max(got) if got else None
