"""Device-to-host reads a pivot over the traced chunk of the steady loop:
the program's ``read`` spans (``simplex_tpu_torch.spans``, one at each place
that adds to ``core.step.host_reads``) over the chunk's pivots. None where
the program records no spans."""


def read(ctx):
    try:
        from simplex_tpu_torch import spans
    except ImportError:
        return None
    recs, pivots = spans.latest(), (ctx["trace"] or {}).get("pivots", 0)
    if not recs or pivots <= 0:
        return None
    return sum(r.name == "read" for r in recs) / pivots
