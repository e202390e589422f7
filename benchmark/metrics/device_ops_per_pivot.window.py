"""Device operations (kernels, memsets, copies) a pivot over the traced
chunk of the steady loop, the mean over the ranks."""

from benchmark.trace import rank_summaries


def read(ctx):
    got = [s["n_ops"] / s["pivots"] for s in rank_summaries(ctx["trace"]) if s["pivots"] > 0]
    return sum(got) / len(got) if got else None
