"""The share of the traced stretch (one whole solve to OPTIMAL) in which no
operation ran on the device: 1 - (the union of the operations' intervals
over the stretch's wall time), the mean over the ranks."""

from benchmark.trace import idle_share


def read(ctx):
    return idle_share(ctx)
