"""The engine's dispatch stage seconds (`engine.stats`) per batch, over the
window's untraced jobs."""

from benchmark.metrics._common import untraced


def read(ctx):
    jobs = untraced(ctx)
    batches = sum(j.batches for j in jobs)
    return sum(j.stage_s.get("dispatch", 0.0) for j in jobs) / batches * 1e3 if batches else None
