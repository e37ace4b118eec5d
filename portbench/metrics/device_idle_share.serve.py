"""Share of the traced slice in which no operation ran on the device, in
percent (the union of the profiler's device intervals)."""
from portbench.metrics import idle


def read(ctx):
    return idle.share(ctx)
