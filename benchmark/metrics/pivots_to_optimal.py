"""Pivots a solve took to OPTIMAL (``SolveResult.iters``), the mean over
the window's solves."""


def read(ctx):
    iters = ctx["run"].iters
    return sum(iters) / len(iters) if iters else None
