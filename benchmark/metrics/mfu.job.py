"""FLOP the algorithm needs over wall time, as a share of the card's fp32 peak."""

from benchmark.metrics._common import mfu


def read(ctx):
    return mfu(ctx)
