"""The device's idle time at the head of each step, measured where the host
causes it, over the traced chunk of the steady loop: from the end of each of
the program's ``read`` spans (``simplex_tpu_torch.spans``; a read returns
only once the stream is empty) to the next ``launch:`` mark of a
hand-written kernel, or to the start of the next stage span that holds no
such mark (its first device operation is a torch op), whichever comes
first; summed, in us over the chunk's pivots. None where the program
records no spans."""

import bisect

STAGES = ("price", "ftran", "tail", "update", "weights", "maintain", "verify", "polish")


def read(ctx):
    try:
        from simplex_tpu_torch import spans
    except ImportError:
        return None
    recs, pivots = spans.latest(), (ctx["trace"] or {}).get("pivots", 0)
    if not recs or pivots <= 0:
        return None
    launching = set()
    for r in recs:
        if r.name.startswith("launch:"):
            i = r.parent
            while i >= 0 and i not in launching:
                launching.add(i)
                i = recs[i].parent
    ends = sorted(
        [r.start_ns for r in recs if r.name.startswith("launch:")]
        + [r.start_ns for i, r in enumerate(recs) if r.name in STAGES and i not in launching]
    )
    ns = 0
    for r in recs:
        if r.name != "read" or r.end_ns < 0:
            continue
        k = bisect.bisect_left(ends, r.end_ns)
        if k < len(ends):
            ns += ends[k] - r.end_ns
    return 1e-3 * ns / pivots
