"""Mel filterbank construction (torchaudio-`melscale_fbanks` semantics).

The reference vendors torchaudio's MelScale (examples/NVSR/mel_scale.py) and
instantiates it as MelScale(n_mels=128, sample_rate=44100, n_stft=1025) with
defaults f_min=0, f_max=sr/2, norm=None, mel_scale='htk'
(nvsr_unet.py:97).  The filterbank is a host-built NumPy matrix applied as
one float32 [*, F] x [F, M] matmul on the device (TF32 is pinned off by
`device.pin_precision`).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn


def _hz_to_mel(f, mel_scale="htk"):
    f = np.asarray(f, dtype=np.float64)
    if mel_scale == "htk":
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(f / min_log_hz) / logstep, mels)


def _mel_to_hz(m, mel_scale="htk"):
    m = np.asarray(m, dtype=np.float64)
    if mel_scale == "htk":
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


@functools.lru_cache(maxsize=16)
def melscale_fbanks(
    n_freqs: int,
    f_min: float,
    f_max: float,
    n_mels: int,
    sample_rate: int,
    norm: str | None = None,
    mel_scale: str = "htk",
) -> np.ndarray:
    """Triangular filterbank [n_freqs, n_mels], float32 (torchaudio layout)."""
    all_freqs = np.linspace(0, sample_rate // 2, n_freqs)
    m_min = _hz_to_mel(f_min, mel_scale)
    m_max = _hz_to_mel(f_max, mel_scale)
    m_pts = np.linspace(m_min, m_max, n_mels + 2)
    f_pts = _mel_to_hz(m_pts, mel_scale)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - all_freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    fb = np.maximum(0.0, np.minimum(down, up))
    if norm == "slaney":
        enorm = 2.0 / (f_pts[2 : n_mels + 2] - f_pts[:n_mels])
        fb *= enorm[None, :]
    return fb.astype(np.float32)


class MelScale(nn.Module):
    """spec [..., T, F] -> mel [..., T, M].  The filterbank is a
    non-persistent buffer: it is rebuilt from the constructor's arguments,
    so it never appears in a state dict."""

    def __init__(self, n_mels=128, sample_rate=44100, n_stft=1025, f_min=0.0, f_max=None):
        super().__init__()
        f_max = f_max if f_max is not None else sample_rate / 2
        fb = melscale_fbanks(n_stft, f_min, f_max, n_mels, sample_rate)
        self.register_buffer("fb", torch.from_numpy(fb.copy()), persistent=False)

    def forward(self, spec: torch.Tensor) -> torch.Tensor:
        # DSP, not model compute: float32 under a bfloat16 autocast too.
        with torch.autocast(spec.device.type, enabled=False):
            return torch.matmul(spec.to(torch.float32), self.fb)
