"""Rank-1 updates with the next step's ftran fused in
(``rank1_update_ftran``) a pivot over the traced chunk of the steady loop:
the traced chunk's rank-1 launches a pivot (``hopper.launches``, which
counts the fused launches under ``rank1_update``), times the share of the
run's rank-1 launches that the program's counter (``hopper.rank1_layouts``,
graph replays included) puts under ``ftran``. The benchmark resets neither
counter, so the share is over the whole run, whose calls all have the
traced chunk's shape. None where the program has no such counter or
launched no rank-1 kernel."""


def read(ctx):
    from simplex_tpu_torch.kernels import hopper

    layouts = getattr(hopper, "rank1_layouts", None)
    trace = ctx["trace"] or {}
    calls, pivots = hopper.launches.get("rank1_update", 0), trace.get("pivots", 0)
    if layouts is None or calls <= 0 or pivots <= 0:
        return None
    return layouts["ftran"] / calls * trace["launches"].get("rank1_update", 0) / pivots
