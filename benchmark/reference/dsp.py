"""The evaluation pipeline's arithmetic in plain PyTorch, one utterance at a
time, for the benchmark's comparison.

It imports nothing of the program under test.  Every function works in the
dtype of its input (float64 for the reference) and takes `rnd`, which is
applied to both operands of every product-sum that the program runs as a
matrix product (the resamplers' taps, the mel filterbank, convolutions):
`identity` for the reference, `tf32` for the control, which rounds them to
TF32's 10-bit mantissa as the card does with TF32 switched on.

Semantics (the reference's librosa / scipy / skimage defaults):
- resample: scipy.signal.resample_poly (firwin with a Kaiser window of beta
  5.0, half length 10 * max(up, down), gain up).
- STFT: centred, reflect padding of n_fft // 2, periodic Hann of n_fft.
- iSTFT: inverse rFFT, window, overlap-add, divide by the window sum of
  squares where it is above 1e-10, drop the padding, cut to the length.
- fft degradation: STFT 2048/441, zero every bin >= int(1025 * ratio),
  iSTFT to the input's length (`benchmark/degrade/fft.py` names its specs).
- metrics (ssr_eval metrics.py): LSD, log-SiSpec, SiSpec and skimage's SSIM
  (7 x 7 uniform window, data range 2) on |STFT| with hop rate / 100 and
  n_fft int(2048 / (44100 / rate)), both signals cut to the shorter.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

EPS = 1e-12
DEGRADE_NFFT, DEGRADE_HOP = 2048, 441


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


def tf32(t: torch.Tensor) -> torch.Tensor:
    """Round float32 (or wider, through float32) to TF32: 10 mantissa bits,
    round to nearest even; the result is float32."""
    i = t.to(torch.float32).contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


# ----------------------------------------------------------------------
# Resampling
# ----------------------------------------------------------------------


def firwin_kaiser(numtaps: int, cutoff: float, beta: float = 5.0) -> np.ndarray:
    """scipy.signal.firwin(numtaps, cutoff, window=("kaiser", beta)): a
    low-pass windowed sinc, cutoff relative to Nyquist, unit gain at DC."""
    m = np.arange(numtaps) - 0.5 * (numtaps - 1)
    h = cutoff * np.sinc(cutoff * m) * np.kaiser(numtaps, beta)
    return h / h.sum()


def _poly_taps(up: int, down: int):
    """-> (H [up, J] phase filters, J, n_pre_remove) of resample_poly."""
    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin_kaiser(2 * half_len + 1, 1.0 / max_rate) * up
    n_pre_pad = down - half_len % down
    h = np.concatenate([np.zeros(n_pre_pad), h])
    J = -(-len(h) // up)
    h = np.concatenate([h, np.zeros(J * up - len(h))])
    return h.reshape(J, up).T.copy(), J, (half_len + n_pre_pad) // down


def resample(x: torch.Tensor, sr_in: int, sr_out: int, rnd=identity) -> torch.Tensor:
    """x [..., L] -> [..., ceil(L * up / down)] with scipy's resample_poly:
    y[k] = sum_j h[r_k + up * j] * x[b_k - j], r_k / b_k the remainder and
    quotient of (k + n_pre_remove) * down by up."""
    g = math.gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    if up == down:
        return x
    L = x.shape[-1]
    H, J, pre = _poly_taps(up, down)
    H = torch.from_numpy(H).to(x.device, x.dtype)
    n_out = -(-L * up // down)
    pos = (torch.arange(n_out, device=x.device) + pre) * down
    r, b = pos % up, pos // up
    idx = b[:, None] - torch.arange(J, device=x.device)[None, :]
    valid = (idx >= 0) & (idx < L)
    X = x[..., idx.clamp(0, L - 1)] * valid
    return (rnd(X) * rnd(H[r])).sum(-1).to(x.dtype)


# ----------------------------------------------------------------------
# STFT, iSTFT, degradation
# ----------------------------------------------------------------------


def hann(n: int, like: torch.Tensor) -> torch.Tensor:
    k = torch.arange(n, device=like.device, dtype=torch.float64)
    return (0.5 - 0.5 * torch.cos(2 * math.pi * k / n)).to(like.dtype)


def stft(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """x [..., L] -> complex [..., T, n_fft // 2 + 1], T = 1 + L // hop."""
    lead = x.shape[:-1]
    xp = F.pad(x.reshape(-1, 1, x.shape[-1]), (n_fft // 2, n_fft // 2), mode="reflect")
    frames = xp[:, 0].unfold(-1, n_fft, hop)
    z = torch.fft.rfft(frames * hann(n_fft, x), dim=-1)
    return z.reshape(*lead, *z.shape[1:])


def istft(z: torch.Tensor, n_fft: int, hop: int, length: int) -> torch.Tensor:
    """z [..., T, bins] -> [..., length]."""
    w = hann(n_fft, z.real)
    frames = torch.fft.irfft(z, n=n_fft, dim=-1) * w
    T = frames.shape[-2]
    total = hop * (T - 1) + n_fft
    lead = frames.shape[:-2]
    fl = frames.reshape(-1, T, n_fft).transpose(1, 2)
    out = F.fold(fl, (1, total), (1, n_fft), stride=(1, hop)).reshape(*lead, total)
    wss = F.fold((w * w)[None, :, None].expand(1, n_fft, T), (1, total), (1, n_fft), stride=(1, hop)).reshape(total)
    ok = wss > 1e-10
    out = torch.where(ok, out / torch.where(ok, wss, torch.ones_like(wss)), out)
    return out[..., n_fft // 2 : n_fft // 2 + length]


def fft_lowpass(x: torch.Tensor, cutoffs_hz, sr: int) -> torch.Tensor:
    """x [L] -> [len(cutoffs), L]: the fft degradation at each cutoff."""
    z = stft(x, DEGRADE_NFFT, DEGRADE_HOP)
    bins = DEGRADE_NFFT // 2 + 1
    keep = torch.stack([
        torch.arange(bins, device=x.device) < int(bins * (c / int(sr / 2))) for c in cutoffs_hz
    ]).to(z.real.dtype)
    return istft(z[None] * keep[:, None, :], DEGRADE_NFFT, DEGRADE_HOP, x.shape[-1])


# ----------------------------------------------------------------------
# Metrics
# ----------------------------------------------------------------------


def metric_stft(rate: int) -> tuple[int, int]:
    return int(2048 / (44100 / rate)), int(rate / 100)


def _sispec(est, tgt):
    pow_norm = (est * tgt).sum((-2, -1), keepdim=True)
    target = pow_norm * tgt / ((tgt**2).sum((-2, -1), keepdim=True) + EPS)
    noise = est - target
    return 10 * torch.log10((target**2).sum((-2, -1)) / ((noise**2).sum((-2, -1)) + EPS) + EPS)


def _box(a, win):
    """'valid' win x win box means of [S, T, F] (local sums: an integral
    image would lose the small variances of quiet bands in float32)."""
    return F.avg_pool2d(a[:, None], win, stride=1)[:, 0]


def _ssim(X, Y, win=7, data_range=2.0):
    NP = win * win
    cov = NP / (NP - 1)
    ux, uy = _box(X, win), _box(Y, win)
    vx = cov * (_box(X * X, win) - ux * ux)
    vy = cov * (_box(Y * Y, win) - uy * uy)
    vxy = cov * (_box(X * Y, win) - ux * uy)
    C1, C2 = (0.01 * data_range) ** 2, (0.03 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / ((ux**2 + uy**2 + C1) * (vx + vy + C2))
    return S.mean((-2, -1))


def metrics(est: torch.Tensor, tgt: torch.Tensor, rate: int) -> dict:
    """est [S, Le], tgt [Lt] -> {metric: [S]} on the common length."""
    n = min(est.shape[-1], tgt.shape[-1])
    n_fft, hop = metric_stft(rate)
    E = stft(est[..., :n], n_fft, hop).abs()
    T = stft(tgt[..., :n], n_fft, hop).abs()[None].expand_as(E)
    ratio = torch.log10(T**2 / ((E + EPS) ** 2) + EPS) ** 2
    return {
        "lsd": ratio.mean(-1).sqrt().mean(-1),
        "log_sispec": _sispec(torch.log10(E + EPS), torch.log10(T + EPS)),
        "sispec": _sispec(E, T),
        "ssim": _ssim(E, T),
    }


def pipeline(pcm: np.ndarray, native_sr: int, plan: dict, degrade, testee, dtype, device, rnd=identity) -> dict:
    """One utterance through the whole sweep: {spec key: {metric: float}}.

    pcm: int16 samples at native_sr; plan: input_sr, output_sr and
    evaluation_sr; degrade(x_in [L], rnd) -> (spec keys, [S, L]) at
    input_sr; testee(degraded [S, L], rnd) -> [S, L'] at output_sr."""
    x = torch.from_numpy(pcm.astype(np.float64) / 32768.0).to(device, dtype)
    x_in = resample(x, native_sr, plan["input_sr"], rnd)
    gt = resample(x, native_sr, plan["evaluation_sr"], rnd)
    keys, degraded = degrade(x_in, rnd)
    y = testee(degraded, rnd)
    est = resample(y, plan["output_sr"], plan["evaluation_sr"], rnd)
    m = {k: v.double().cpu().numpy() for k, v in metrics(est, gt, plan["evaluation_sr"]).items()}
    return {key: {k: float(m[k][i]) for k in ("lsd", "log_sispec", "sispec", "ssim")} for i, key in enumerate(keys)}
