"""Host time of the program's `decode.native` span (the native FLAC batch
decode, `io/flac_native.py`) per batch, over the window's untraced jobs."""

from benchmark.metrics._common import span_ms_per_batch


def read(ctx):
    return span_ms_per_batch(ctx, "decode.native")
