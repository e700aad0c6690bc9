"""Device idle time inside the program's `decode` spans (the host waiting
for the next batch) per traced job: the spans' union less the intervals in
which a device op ran."""

from benchmark.metrics._common import span_idle_ms_per_job


def read(ctx):
    return span_idle_ms_per_job(ctx, "decode")
