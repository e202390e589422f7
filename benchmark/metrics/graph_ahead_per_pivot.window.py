"""Replays of the captured default pivot step enqueued ahead, a pivot over
the traced chunk of the steady loop: the program's ``graph`` spans of kind
``ahead`` (``simplex_tpu_torch.spans``: a replay enqueued before the
previous step's control words were read) over the chunk's pivots; 0.0 where
the program records spans but none of that kind. None where the program
records no spans."""


def read(ctx):
    try:
        from simplex_tpu_torch import spans
    except ImportError:
        return None
    recs, pivots = spans.latest(), (ctx["trace"] or {}).get("pivots", 0)
    if not recs or pivots <= 0:
        return None
    return sum(r.name == "graph" and r.kind == "ahead" for r in recs) / pivots
