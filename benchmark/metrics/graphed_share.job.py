"""The share of the engine's batches that replayed its CUDA graphs:
100 x dispatch_graphed / (dispatch_graphed + dispatch_eager), from the
program's counters over the window's untraced jobs."""

from benchmark.metrics._common import counter_share


def read(ctx):
    return counter_share(ctx, "dispatch_graphed", ("dispatch_graphed", "dispatch_eager"))
