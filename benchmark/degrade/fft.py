"""The fft degradation family, the helper's `setting_fft`: for each cutoff
c (Hz), an STFT of 2048 / 441, every bin at or above int(1025 * 2c / sr)
zeroed, and the inverse STFT to the input's length (the reference's
`lowpass(..., _type="stft_hard")`).

A family module gives the spec keys the program reports for its settings,
the degradation in plain PyTorch for the reference, and the FLOP the
algorithm needs; the harness finds it by the setting's name."""

from __future__ import annotations

import torch

from benchmark.harness.work import fft_flops
from benchmark.reference import dsp


def _low_rates(settings: dict, sr: int) -> list[int]:
    """The helper's doubled cutoffs; one equal to the rate is taken 1 Hz lower."""
    return [2 * c - (2 * c == sr) for c in settings["cutoff_freq"]]


def spec_keys(settings: dict, sr: int) -> list[str]:
    return [f"proc_fft_{low}_{sr}" for low in _low_rates(settings, sr)]


def degrade(x: torch.Tensor, settings: dict, sr: int, rnd=dsp.identity) -> torch.Tensor:
    """x [L] at sr -> [specs, L]."""
    return dsp.fft_lowpass(x, [low // 2 for low in _low_rates(settings, sr)], sr)


def flop(n: int, settings: dict, sr: int) -> float:
    """One forward STFT of the n-sample input and one inverse a spec."""
    frames = 1 + n // dsp.DEGRADE_HOP
    return (1 + len(settings["cutoff_freq"])) * frames * fft_flops(dsp.DEGRADE_NFFT)
