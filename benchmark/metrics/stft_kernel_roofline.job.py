"""The |STFT| kernel's share of its roofline over the traced jobs."""

from benchmark.metrics._common import stft_roofline


def read(ctx):
    return stft_roofline(ctx)
