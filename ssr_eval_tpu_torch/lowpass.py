"""Drop-in module-path shim for the reference's `ssr_eval.lowpass`."""

from ssr_eval_tpu_torch.degrade.lowpass import (
    align_length,
    bandpass,
    bandpass_filter,
    limit,
    lowpass,
    lowpass_filter,
    stft_hard_lowpass_v0,
    subsampling,
    test1,
)

__all__ = [
    "align_length",
    "bandpass",
    "bandpass_filter",
    "limit",
    "lowpass",
    "lowpass_filter",
    "stft_hard_lowpass_v0",
    "subsampling",
    "test1",
]
