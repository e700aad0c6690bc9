"""Host time of the helper per job: the job's wall time less the engine's
stage seconds over the job (`engine.stats`: decode, dispatch, drain and any
host-testee or codec stage): listing the tree, the journal, aggregation,
the results JSON.  Over the window's untraced jobs."""

from benchmark.metrics._common import untraced


def read(ctx):
    jobs = untraced(ctx)
    if not jobs:
        return None
    return sum(j.wall_s - sum(j.stage_s.values()) for j in jobs) / len(jobs) * 1e3
