"""Median wall time of one evaluate() call, over every job in the window."""

import numpy as np


def read(ctx):
    return float(np.percentile([j.wall_s for j in ctx.jobs], 50)) * 1e3 if ctx.jobs else None
