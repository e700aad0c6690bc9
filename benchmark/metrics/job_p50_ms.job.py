"""Median wall time of one evaluate() call, over the window's untraced
jobs: a validation call's latency on the host's clock (per layer, since on
the card's shared host its median swings between processes by more than
the largest bound allows)."""

import numpy as np

from benchmark.metrics._common import untraced


def read(ctx):
    jobs = untraced(ctx)
    return float(np.percentile([j.wall_s for j in jobs], 50)) * 1e3 if jobs else None
