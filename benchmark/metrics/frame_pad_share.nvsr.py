"""The UNet frames that the bucket wastes: 100 x (1 - nvsr_frames_real /
nvsr_frames_slots), from NVSRTestee's counters over the window's untraced
jobs (real: each row's own frames rounded up to the UNet's 64; slots: rows
x the bucket's frames rounded up to 64)."""

from benchmark.metrics._common import counter_share


def read(ctx):
    real = counter_share(ctx, "nvsr_frames_real", "nvsr_frames_slots")
    return None if real is None else 100.0 - real
