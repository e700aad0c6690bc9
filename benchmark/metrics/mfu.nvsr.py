"""FLOP the algorithm needs (the model's counted from its layer shapes,
configs/nvsr_unet_fp32.json) over wall time, as a share of the card's fp32
peak."""

from benchmark.metrics._common import mfu


def read(ctx):
    return mfu(ctx)
