"""95th percentile (linear interpolation) of the wall time of one
evaluate() call, over the window's untraced jobs: the tail beside the
median `job_p50_ms.job` (on the card's shared host both swing too much
between processes for a bound)."""

import numpy as np

from benchmark.metrics._common import untraced


def read(ctx):
    jobs = untraced(ctx)
    return float(np.percentile([j.wall_s for j in jobs], 95)) * 1e3 if jobs else None
