"""Host time of the program's `dispatch.prep` span per batch (the input
copies to the card, the int16 rescale and the input resamples; on a batch
that replays the engine's CUDA graphs, the copies into their static
inputs), over the window's untraced jobs."""

from benchmark.metrics._common import span_ms_per_batch


def read(ctx):
    return span_ms_per_batch(ctx, "dispatch.prep")
