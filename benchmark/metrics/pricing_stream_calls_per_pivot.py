"""``pricing_scan`` calls in the float64 "stream" layout a pivot over the
traced chunk of the steady loop: the traced chunk's pricing calls a pivot
(``hopper.launches``), times the share of the run's pricing calls that the
program's layout counter (``hopper.pricing_layouts``, graph replays
included) puts in the stream layout. The benchmark resets neither counter,
so the share is over the whole run, whose calls all have the traced chunk's
shape. None where the program has no layout counter or launched no pricing
kernel."""


def read(ctx):
    from simplex_tpu_torch.kernels import hopper

    layouts = getattr(hopper, "pricing_layouts", None)
    trace = ctx["trace"] or {}
    calls, pivots = hopper.launches.get("pricing_scan", 0), trace.get("pivots", 0)
    if layouts is None or calls <= 0 or pivots <= 0:
        return None
    return layouts["stream"] / calls * trace["launches"].get("pricing_scan", 0) / pivots
