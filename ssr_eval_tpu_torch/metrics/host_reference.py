"""Float64 host implementation of the metric chain — the exact-precision
cross-check mode (PARITY.md deviation 4), and the float64 oracle of
chip_smoke.py's card checks.

The device pipeline computes metrics in float32; in strongly-masked bands
the est-spectrogram sits at the f32 rounding floor, which makes per-pair
LSD implementation-specific there.  This module evaluates the identical
formulas in float64 NumPy (vectorized: stride-tricks framing + batch
rFFT), for users who need bit-faithful comparison against f64 CPU
references.  Select it with ``AudioMetrics(rate, precision="float64")``
or the engine's ``metrics_backend="host_float64"``.  A verification tool,
not the throughput path.

`stft_np`, `istft_np`, `lsd_np`, `sispec_np` and `ssim_np` replicate the
reference's librosa STFT / iSTFT, metric formulas and skimage SSIM
(librosa 0.9.x semantics: reflect padding of n_fft // 2, periodic Hann,
overlap-add normalised by the window-sum-square); each gives the same
float64 numbers, bit for bit, as the repository's test oracle of the same
name at these arguments.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-12


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def stft_np(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Complex STFT [n_bins, n_frames] (librosa layout): center reflect
    padding, periodic Hann of n_fft, frames at stride hop."""
    y = np.pad(np.asarray(y, dtype=np.float64), n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    frames = np.lib.stride_tricks.sliding_window_view(y, n_fft)[::hop][:n_frames]
    return np.fft.rfft(frames * _hann(n_fft), axis=-1).T


def istft_np(Z: np.ndarray, n_fft: int, hop: int, length: int | None = None) -> np.ndarray:
    """Z: complex [n_bins, n_frames] -> time signal: inverse rFFT per frame,
    windowed, overlap-added, divided by the window-sum-square where it is
    above 1e-10, the n_fft // 2 centre padding trimmed, cut to `length`."""
    w = _hann(n_fft)
    frames = np.fft.irfft(Z.T, n=n_fft, axis=-1) * w
    total = hop * (frames.shape[0] - 1) + n_fft
    out = np.zeros(total)
    wss = np.zeros(total)
    for i, frame in enumerate(frames):
        out[i * hop : i * hop + n_fft] += frame
        wss[i * hop : i * hop + n_fft] += w * w
    nz = wss > 1e-10
    out[nz] /= wss[nz]
    out = out[n_fft // 2 :]
    return out if length is None else out[:length]


def stft_mag_f64(y: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """|STFT| [T, F] with librosa semantics (center reflect, periodic hann)."""
    return np.abs(stft_np(y, n_fft, hop)).T


def lsd_np(est_sp: np.ndarray, target_sp: np.ndarray) -> float:
    """LSD on [T, F] magnitude spectrograms (reference metrics.py:109-112;
    the asymmetric epsilon preserved)."""
    ratio = np.log10(target_sp**2 / ((est_sp + EPS) ** 2) + EPS) ** 2
    return float(np.mean(np.mean(ratio, axis=1) ** 0.5))


def sispec_np(est_sp: np.ndarray, target_sp: np.ndarray) -> float:
    """SiSpec on [T, F] magnitude spectrograms (reference metrics.py:114-121):
    the target scaled by <est, target> / ||target||^2 over all of [T, F]."""
    pow_norm = np.sum(est_sp * target_sp)
    target = pow_norm * target_sp / (np.sum(target_sp**2) + EPS)
    noise = est_sp - target
    return float(10 * np.log10(np.sum(target**2) / (np.sum(noise**2) + EPS) + EPS))


def _box_valid(a: np.ndarray, win: int) -> np.ndarray:
    c = np.cumsum(np.cumsum(np.pad(a, ((1, 0), (1, 0))), axis=0), axis=1)
    s = c[win:, win:] - c[:-win, win:] - c[win:, :-win] + c[:-win, :-win]
    return s / (win * win)


def ssim_np(est_sp: np.ndarray, target_sp: np.ndarray, win_size: int = 7, data_range: float = 2.0) -> float:
    """skimage.metrics.structural_similarity defaults on float images
    (reference metrics.py:131): uniform 7x7 window, unbiased covariance,
    data_range 2; the crop of (win_size - 1) // 2 per side makes the valid
    box filter exact."""
    X = est_sp.astype(np.float64)
    Y = target_sp.astype(np.float64)
    NP = win_size * win_size
    cov_norm = NP / (NP - 1)
    ux, uy = _box_valid(X, win_size), _box_valid(Y, win_size)
    uxx, uyy, uxy = _box_valid(X * X, win_size), _box_valid(Y * Y, win_size), _box_valid(X * Y, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux**2 + uy**2 + C1) * (vx + vy + C2))
    return float(S.mean())


def spectral_metrics_np(est_sp: np.ndarray, target_sp: np.ndarray) -> dict:
    """The four metrics of two [T, F] magnitude spectrograms."""
    return {
        "lsd": lsd_np(est_sp, target_sp),
        "log_sispec": sispec_np(np.log10(est_sp + EPS), np.log10(target_sp + EPS)),
        "sispec": sispec_np(est_sp, target_sp),
        "ssim": ssim_np(est_sp, target_sp),
    }


def evaluate_f64(est: np.ndarray, target: np.ndarray, rate: int) -> dict:
    """The four metrics in float64 (formulas of reference metrics.py:51-132)."""
    hop = int(rate / 100)
    n_fft = int(2048 / (44100 / rate))
    min_len = min(len(est), len(target))
    return spectral_metrics_np(stft_mag_f64(est[:min_len], n_fft, hop), stft_mag_f64(target[:min_len], n_fft, hop))
