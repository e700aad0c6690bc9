"""The bucket padding's share of the samples the engine's batches hold:
100 x (1 - samples_real / samples_slots), from the program's counters
(`_pack_batch`) over the window's untraced jobs."""

from benchmark.metrics._common import counter_share


def read(ctx):
    real = counter_share(ctx, "samples_real", "samples_slots")
    return None if real is None else 100.0 - real
