"""Host time a pivot over the traced chunk of the steady loop, reads left
out: the program's ``pivot`` spans (``simplex_tpu_torch.spans``: the step,
its control read, any upkeep) less the ``read`` spans inside them, summed,
in us over the chunk's pivots. That is the host's Python and launch work,
which sets the pace wherever it exceeds the device's. None where the
program records no spans."""


def _pivot_of(recs, i):
    while i >= 0 and recs[i].name != "pivot":
        i = recs[i].parent
    return i


def read(ctx):
    try:
        from simplex_tpu_torch import spans
    except ImportError:
        return None
    recs, pivots = spans.latest(), (ctx["trace"] or {}).get("pivots", 0)
    if not recs or pivots <= 0:
        return None
    ns = sum(r.end_ns - r.start_ns for r in recs if r.name == "pivot" and r.end_ns >= 0)
    for r in recs:
        if r.name == "read" and r.end_ns >= 0 and _pivot_of(recs, r.parent) >= 0:
            ns -= r.end_ns - r.start_ns
    return 1e-3 * ns / pivots
