"""Full cross-correlation via FFT (replaces scipy.signal.correlate at
reference eval.py:319 for the mp3 decode alignment), on 1-D tensors."""

from __future__ import annotations

import torch


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def cross_correlate_full(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """scipy.signal.correlate(a, b, mode='full') for 1-D real inputs.

    c[k] = sum_n a[n] * b[n - k + len(b) - 1],  k in [0, la + lb - 1),
    computed as the linear convolution of `a` with reversed `b` by rFFT.
    """
    la, lb = a.shape[0], b.shape[0]
    n = _next_pow2(la + lb - 1)
    A = torch.fft.rfft(a, n=n)
    B = torch.fft.rfft(b.flip(0), n=n)
    return torch.fft.irfft(A * B, n=n)[: la + lb - 1]


def align_by_correlation(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Shift `y` to best-align with `x` (reference eval.py:319-320,272-278).

    shift = argmax(correlate(y, x)) - len(x); a positive shift drops the
    head of y, a negative one delays it (zero fill), like the reference's
    `shift` helper.  The formula is one sample off the true lag, as in the
    reference; it is kept.
    """
    c = cross_correlate_full(y, x)
    shift = torch.argmax(c) - x.shape[0]
    n = y.shape[0]
    idx = torch.arange(n, device=y.device) + shift
    valid = (idx >= 0) & (idx < n)
    return torch.where(valid, y[idx.clamp(0, n - 1)], 0.0)
