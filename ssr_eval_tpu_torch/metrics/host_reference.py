"""Float64 host implementation of the metric chain — the exact-precision
cross-check mode (PARITY.md deviation 4).

The device pipeline computes metrics in float32; in strongly-masked bands
the est-spectrogram sits at the f32 rounding floor, which makes per-pair
LSD implementation-specific there.  This module evaluates the identical
formulas in float64 NumPy (vectorized: stride-tricks framing + batch
rFFT), for users who need bit-faithful comparison against f64 CPU
references.  Select it with ``AudioMetrics(rate, precision="float64")``
or the engine's ``metrics_backend="host_float64"``.  A verification tool,
not the throughput path.
"""

from __future__ import annotations

import numpy as np


def stft_mag_f64(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """|STFT| [T, F] with librosa semantics (center reflect, periodic hann)."""
    y = np.asarray(y, dtype=np.float64)
    pad = n_fft // 2
    yp = np.pad(y, pad, mode="reflect")
    n_frames = 1 + (len(yp) - n_fft) // hop
    frames = np.lib.stride_tricks.sliding_window_view(yp, n_fft)[::hop][:n_frames]
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n_fft) / n_fft)
    return np.abs(np.fft.rfft(frames * w, axis=-1))


def _box_valid(a: np.ndarray, win: int) -> np.ndarray:
    c = np.cumsum(np.cumsum(np.pad(a, ((1, 0), (1, 0))), axis=0), axis=1)
    s = c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win]
    return s / (win * win)


def evaluate_f64(est: np.ndarray, target: np.ndarray, rate: int) -> dict:
    """The four metrics in float64 (formulas of reference metrics.py:51-132)."""
    EPS = 1e-12
    hop = int(rate / 100)
    n_fft = int(2048 / (44100 / rate))
    min_len = min(len(est), len(target))
    est_sp = stft_mag_f64(est[:min_len], n_fft, hop)
    tgt_sp = stft_mag_f64(target[:min_len], n_fft, hop)

    # LSD (asymmetric epsilon preserved)
    ratio = np.log10(tgt_sp**2 / ((est_sp + EPS) ** 2) + EPS) ** 2
    lsd = float(np.mean(np.sqrt(np.mean(ratio, axis=1))))

    def sispec(e, t):
        pn = np.sum(e * t)
        scaled = pn * t / (np.sum(t * t) + EPS)
        noise = e - scaled
        return float(10 * np.log10(np.sum(scaled**2) / (np.sum(noise**2) + EPS) + EPS))

    # SSIM (skimage defaults: uniform 7x7, unbiased cov, data_range 2)
    win = 7
    NP = win * win
    cov_norm = NP / (NP - 1)
    ux, uy = _box_valid(est_sp, win), _box_valid(tgt_sp, win)
    uxx, uyy, uxy = (
        _box_valid(est_sp * est_sp, win),
        _box_valid(tgt_sp * tgt_sp, win),
        _box_valid(est_sp * tgt_sp, win),
    )
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1, C2 = (0.01 * 2.0) ** 2, (0.03 * 2.0) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux**2 + uy**2 + C1) * (vx + vy + C2))

    return {
        "lsd": lsd,
        "log_sispec": sispec(np.log10(est_sp + EPS), np.log10(tgt_sp + EPS)),
        "sispec": sispec(est_sp, tgt_sp),
        "ssim": float(S.mean()),
    }
