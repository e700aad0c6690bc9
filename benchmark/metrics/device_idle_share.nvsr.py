"""1 - device busy seconds a job (from the traced jobs) / wall seconds a job
(from the window's untraced jobs)."""

from benchmark.metrics._common import idle_share


def read(ctx):
    return idle_share(ctx)
