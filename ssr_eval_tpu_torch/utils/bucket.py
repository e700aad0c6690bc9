"""Length bucketing: variable-length utterances -> a small set of static
buffer lengths, so a batch of mixed-length utterances shares one set of
tensor shapes (masks carry the true lengths)."""

from __future__ import annotations


def bucket_length(n: int, floor: int = 4096) -> int:
    """Smallest (1, 1.25, 1.5, 1.75) * 2^k >= n."""
    if n <= floor:
        return floor
    k = (n - 1).bit_length()
    base = 1 << (k - 1)
    for mult in (1.25, 1.5, 1.75, 2.0):
        b = int(base * mult)
        if b >= n:
            return b
    return 1 << k


def pow2_bucket(n: int, floor: int = 4096) -> int:
    """max(floor, next power of two >= n): the single-utterance bucket of
    the reference-API conveniences (lowpass, postprocessing)."""
    return max(floor, 1 << (n - 1).bit_length())
