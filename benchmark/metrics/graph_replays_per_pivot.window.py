"""Replays of the captured default pivot step a pivot over the traced chunk
of the steady loop: the program's ``launch:pivot_graph`` marks
(``simplex_tpu_torch.spans``, one before each replay of
``core.graph.StepGraphs``) over the chunk's pivots. None where the program
records no spans."""


def read(ctx):
    try:
        from simplex_tpu_torch import spans
    except ImportError:
        return None
    recs, pivots = spans.latest(), (ctx["trace"] or {}).get("pivots", 0)
    if not recs or pivots <= 0:
        return None
    return sum(r.name == "launch:pivot_graph" for r in recs) / pivots
