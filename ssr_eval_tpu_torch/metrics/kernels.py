"""The four SSR evaluation metrics on batched spectrograms.

Formula-for-formula the reference's ssr_eval/metrics.py, as in
``ssr_eval_tpu.metrics.kernels``:

- metric STFT parameters derive from the evaluation rate:
  hop = int(rate/100), n_fft = int(2048/(44100/rate))   (metrics.py:17-19)
  e.g. 44100 -> (441, 2048); 48000 -> (480, 2229); 16000 -> (160, 743).
- both signals truncate to the shorter length (metrics.py:89-90): a
  per-utterance `min_len` with frame masks.
- LSD keeps the asymmetric epsilon: log10(target^2/(est+EPS)^2 + EPS).
- SiSpec projects target onto est energy (energy_unify, utils.py:79-92).
- log-SiSpec is SiSpec of log10(sp + 1e-12) spectrograms.
- SSIM matches skimage structural_similarity defaults on float
  spectrograms with win_size=7: uniform 7x7 window, unbiased covariance,
  data_range = 2.0, border crop of 3 — so 'valid' box sums are exact.

Everything is a masked reduction over [B, max_frames, n_bins] magnitudes
and returns one value per utterance ([B]).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ssr_eval_tpu_torch.dsp.spectral import StftConfig, n_frames_for_length, stft_magnitude

EPS = 1e-12
SSIM_WIN = 7
SSIM_DATA_RANGE = 2.0  # legacy skimage float dtype_range (-1, 1)


@functools.lru_cache(maxsize=16)
def metric_stft_config(rate: int) -> StftConfig:
    """STFT parameters derived from the evaluation rate (metrics.py:17-19)."""
    return StftConfig(n_fft=int(2048 / (44100 / rate)), hop=int(rate / 100))


def _to_log(x):
    return torch.log10(x + EPS)


def _lsd(est_sp, tgt_sp, fmask):
    """Log-spectral distance over valid frames; [B,T,F] inputs, [B,T] mask."""
    ratio = torch.log10(tgt_sp**2 / ((est_sp + EPS) ** 2) + EPS) ** 2
    per_frame = torch.sqrt(torch.mean(ratio, dim=-1))
    n = torch.clamp(fmask.sum(dim=-1), min=1.0)
    return torch.where(fmask > 0, per_frame, torch.zeros_like(per_frame)).sum(dim=-1) / n


def _sum_tf(x, keepdim=False):
    """Sum of [B, T, F] over frames and bins, bins first: a row's sum takes
    one order whatever its batch's rows (on the CPU one reduction over both
    dims of a lone row splits the row across threads)."""
    s = x.sum(dim=-1).sum(dim=-1)
    return s[..., None, None] if keepdim else s


def _sispec(est_sp, tgt_sp):
    """Scale-invariant spectral SNR; inputs pre-masked (invalid rows = 0)."""
    pow_norm = _sum_tf(est_sp * tgt_sp, keepdim=True)
    target = pow_norm * tgt_sp / (_sum_tf(tgt_sp**2, keepdim=True) + EPS)
    noise = est_sp - target
    return 10.0 * torch.log10(_sum_tf(target**2) / (_sum_tf(noise**2) + EPS) + EPS)


def _box_valid_means(a, win):
    """'valid'-mode win x win box means of [B,T,F] -> [B, T-win+1, F-win+1].

    Local sums (never integral-image cumsums: global cumulative sums in
    float32 lose ~1e-7 * total relative precision, which erases the tiny
    variances of masked high-band regions), then one division."""
    s = F.avg_pool2d(a.unsqueeze(1), win, stride=1, divisor_override=1).squeeze(1)
    return s / (win * win)


def ssim_target_moments(tgt_m):
    """SSIM box moments (uy, uyy) of a masked target spectrogram; they
    depend only on the target, so a sweep computes them once per utterance
    and shares them across every degradation spec."""
    return _box_valid_means(tgt_m, SSIM_WIN), _box_valid_means(tgt_m * tgt_m, SSIM_WIN)


def _ssim(est_sp, tgt_sp, n_frames, tgt_moments=None):
    """Mean SSIM over valid window positions (t < n_frames - win + 1)."""
    win = SSIM_WIN
    X, Y = est_sp, tgt_sp
    ux = _box_valid_means(X, win)
    if tgt_moments is None:
        uy, uyy = ssim_target_moments(Y)
    else:
        uy, uyy = tgt_moments
    uxx = _box_valid_means(X * X, win)
    uxy = _box_valid_means(X * Y, win)
    NP = win * win
    cov_norm = NP / (NP - 1)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (0.01 * SSIM_DATA_RANGE) ** 2
    C2 = (0.03 * SSIM_DATA_RANGE) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux**2 + uy**2 + C1) * (vx + vy + C2))
    t = torch.arange(S.shape[1], device=S.device)[None, :]
    mask = (t < (n_frames - win + 1)[:, None]).to(S.dtype)  # [B, T']
    count = torch.clamp(mask.sum(dim=-1) * S.shape[2], min=1.0)
    return _sum_tf(S * mask[:, :, None]) / count


def spectral_metrics_with_target(
    est, min_len, tgt_sp, cfg: StftConfig, max_frames: int, tgt_ssim_moments=None
):
    """Metrics of `est` [B, L] against precomputed target magnitudes.

    `tgt_sp` [B, max_frames, n_bins] is the |STFT| of the target truncated
    to the same `min_len` [B].  `tgt_ssim_moments` optionally shares the
    target's SSIM box moments (`ssim_target_moments(tgt_sp * m2)`).
    -> dict of [B] float32 tensors."""
    est_sp = stft_magnitude(est, min_len, cfg, max_frames)
    nf = n_frames_for_length(cfg, min_len)
    fmask = (torch.arange(max_frames, device=est.device)[None, :] < nf[:, None]).to(est_sp.dtype)
    m2 = fmask[:, :, None]
    est_m = est_sp * m2
    tgt_m = tgt_sp * m2
    return {
        "lsd": _lsd(est_sp, tgt_sp, fmask),
        "log_sispec": _sispec(_to_log(est_sp) * m2, _to_log(tgt_sp) * m2),
        "sispec": _sispec(est_m, tgt_m),
        "ssim": _ssim(est_m, tgt_m, nf, tgt_ssim_moments),
    }


def spectral_metrics(est, est_len, tgt, tgt_len, cfg: StftConfig, max_frames: int):
    """All four metrics for buffered (est, target) pairs [B, L] with true
    lengths [B], analysed at min(est_len, tgt_len) (metrics.py:89-90)."""
    min_len = torch.minimum(est_len, tgt_len)
    tgt_sp = stft_magnitude(tgt, min_len, cfg, max_frames)
    return spectral_metrics_with_target(est, min_len, tgt_sp, cfg, max_frames)


def batched_spectral_metrics(est, est_lens, tgt, tgt_lens, cfg: StftConfig, max_frames: int):
    """The JAX package's vmap of its one-pair `spectral_metrics` over the
    utterance axis.  Here `spectral_metrics` already takes [B, Lmax]
    buffers, so this is the same function: -> dict of [B] tensors."""
    return spectral_metrics(est, est_lens, tgt, tgt_lens, cfg, max_frames)
