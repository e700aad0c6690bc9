"""STFT / iSTFT with librosa & torchlibrosa semantics on batched buffers.

Every function takes a batch of zero-padded buffers ``[B, Lmax]`` and a
per-utterance true length ``[B]`` (an integer tensor), the layout of the
JAX package with its ``vmap`` axis written out.  Semantics (periodic Hann
window, ``center=True`` reflect padding on the TRUE length, frame masks
downstream) are those of ``ssr_eval_tpu.dsp.spectral``.

- The forward transform is ``torch.fft.rfft`` of the windowed frames.
  No DFT matmul: a CPU GEMM's rows change with the row count M, which
  breaks batch-composition invariance.
- ``stft_magnitude`` goes through ``dsp.stft_kernel``: the hand-written
  CUDA kernel on a card tensor, its plain PyTorch version on a CPU tensor.
- ``istft`` overlap-adds as K static shifted adds (no scatter-add: atomics
  add in a different order from run to run) and divides by the closed-form
  window-sum-square of the valid frames.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel


class StftConfig(NamedTuple):
    """STFT configuration.

    - degradation STFT: n_fft=2048, hop=441  (reference dsp.py:7-10)
    - metric STFT: hop=int(rate/100), n_fft=int(2048/(44100/rate))
      (reference metrics.py:17-19)
    - librosa defaults (BasicTestee.postprocessing): n_fft=2048, hop=512
    """

    n_fft: int
    hop: int
    win_length: Optional[int] = None  # None -> n_fft
    center: bool = True  # reflect padding of n_fft // 2 on each side
    pad_mode: str = "reflect"  # the only mode (librosa's default)

    @property
    def win(self) -> int:
        return self.win_length if self.win_length is not None else self.n_fft

    @property
    def pad(self) -> int:
        return self.n_fft // 2 if self.center else 0

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def max_frames(self, max_len: int) -> int:
        """Frame count for the longest signal in a bucket."""
        return max(1, 1 + (max_len + 2 * self.pad - self.n_fft) // self.hop)


def n_frames_for_length(cfg: StftConfig, length):
    """Number of valid STFT frames for a length (int or integer tensor)."""
    n = 1 + (length + 2 * cfg.pad - cfg.n_fft) // cfg.hop
    if isinstance(n, torch.Tensor):
        return torch.clamp(n, min=1)
    return max(1, n)


@functools.lru_cache(maxsize=32)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic ('fftbins') Hann window, float64 host-side; cast at use site."""
    n = np.arange(win_length, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)


@functools.lru_cache(maxsize=16)
def _padded_window64(n_fft: int, win_length: int) -> np.ndarray:
    """Window center-padded to n_fft, float64 (librosa util.pad_center)."""
    win = hann_window(win_length)
    if win_length < n_fft:
        lpad = (n_fft - win_length) // 2
        win = np.pad(win, (lpad, n_fft - win_length - lpad))
    return win


@functools.lru_cache(maxsize=32)
def window_tensor(n_fft: int, win_length: int, device: torch.device) -> torch.Tensor:
    """The padded analysis/synthesis window as a float32 tensor on `device`
    (built in float64, cast once; cached so no host copy per call)."""
    return torch.from_numpy(_padded_window64(n_fft, win_length).astype(np.float32)).to(device)


def _reflect_index(v: torch.Tensor, length: torch.Tensor) -> torch.Tensor:
    """Reflect (no edge repeat) virtual index `v` into [0, length).

    Matches np.pad(mode='reflect'): period 2*(L-1); any integer index."""
    period = torch.clamp(2 * (length - 1), min=1)
    m = torch.remainder(v, period)
    return torch.minimum(m, period - m)


def _extend(x: torch.Tensor, length: torch.Tensor, pad: int) -> torch.Tensor:
    """Reflect-extended buffers: ext[b, v] = x[b, reflect(v - pad, L_b)].

    x: [B, Lmax] holding signals of true lengths `length` [B].  Returns
    [B, Lmax + 2*pad].  Positions in [L + 2*pad, Lmax + 2*pad) hold x's
    zero padding (no valid frame reads them).  The body is a contiguous
    copy; only the two `pad`-sized reflected edges gather.
    """
    if pad == 0:
        return x
    B = x.shape[0]
    length = length.to(torch.int64)[:, None]
    ar = torch.arange(pad, device=x.device, dtype=torch.int64)[None, :]
    left = torch.gather(x, 1, _reflect_index(ar - pad, length))
    right = torch.gather(x, 1, _reflect_index(length + ar, length))
    ext = torch.cat([left, x, x.new_zeros(B, pad)], dim=1)
    # Per-row dynamic update at [pad + L, 2*pad + L): unique indices, so the
    # write is deterministic.
    return ext.scatter_(1, pad + length + ar, right)


def _framing_source(x: torch.Tensor, length: torch.Tensor, cfg: StftConfig, max_frames: int):
    """The buffer frames are cut from ([B, Lext], contiguous), long enough
    for `max_frames` frames."""
    ext = _extend(x, length, cfg.pad) if cfg.center else x
    need = (max_frames - 1) * cfg.hop + cfg.n_fft
    if ext.shape[1] < need:
        ext = F.pad(ext, (0, need - ext.shape[1]))
    return ext.contiguous()


def stft_real_imag(x: torch.Tensor, length: torch.Tensor, cfg: StftConfig, max_frames: int):
    """STFT of buffered signals -> (real, imag), each [B, max_frames, n_bins].

    Frames at index >= n_frames_for_length(cfg, length) are garbage and must
    be masked by the caller."""
    ext = _framing_source(x, length, cfg, max_frames)
    fr = ext.unfold(-1, cfg.n_fft, cfg.hop)[:, :max_frames]
    win = window_tensor(cfg.n_fft, cfg.win, x.device)
    z = torch.fft.rfft(fr * win, n=cfg.n_fft, dim=-1)
    return z.real, z.imag


def stft_magnitude(
    x: torch.Tensor, length: torch.Tensor, cfg: StftConfig, max_frames: int, eps: float = 0.0
) -> torch.Tensor:
    """|STFT| [B, max_frames, n_bins] through the |STFT| kernel (the CUDA
    kernel for a card tensor, its plain version for a CPU tensor).

    A nonzero `eps` floors the power: sqrt(max(|X|^2, eps)), the clamp of
    FDomainHelper.spectrogram (reference dsp.py:72-74) as the JAX package's
    kernel route applies it to the magnitudes."""
    ext = _framing_source(x, length, cfg, max_frames)
    win = window_tensor(cfg.n_fft, cfg.win, x.device)
    mag = stft_magnitude_kernel(ext, cfg.n_fft, cfg.hop, max_frames, win)
    if eps:
        mag = torch.sqrt(torch.clamp(mag * mag, min=eps))
    return mag


def _overlap_add(frames: torch.Tensor, hop: int) -> torch.Tensor:
    """OLA of [B, F, n_fft] frames at stride `hop` -> [B, hop*(F-1) + n_fft].

    K = ceil(n_fft/hop) static shifted adds: frames split into K hop-sized
    columns; column k of all frames lands contiguously at offset k*hop.
    The adds run in a fixed order, so every output sample is independent
    of the batch it sits in."""
    B, Fn, n_fft = frames.shape
    K = -(-n_fft // hop)
    cols = F.pad(frames, (0, K * hop - n_fft)).reshape(B, Fn, K, hop)
    total = hop * (Fn - 1) + n_fft
    out = frames.new_zeros(B, hop * (Fn - 1) + K * hop)
    for k in range(K):
        out[:, k * hop : k * hop + Fn * hop] += cols[:, :, k, :].reshape(B, Fn * hop)
    return out[:, :total]


@functools.lru_cache(maxsize=32)
def _wss_semi_infinite(n_fft: int, hop: int, win_len: int, total: int) -> np.ndarray:
    """W[u] = sum_{f>=0} win2[u - f*hop] over u in [0, total), f64 -> f32.

    For any valid-frame count nf the masked window-sum-square of the OLA
    buffer is the two-term difference wss[j] = W[j] - W[j - nf*hop]
    (second term 0 for j < nf*hop)."""
    w2 = _padded_window64(n_fft, win_len) ** 2
    W = np.zeros(total, dtype=np.float64)
    for f in range(-(-total // hop) + 1):
        lo = f * hop
        if lo >= total:
            break
        hi = min(lo + n_fft, total)
        W[lo:hi] += w2[: hi - lo]
    return W.astype(np.float32)


@functools.lru_cache(maxsize=32)
def _wss_tensors(n_fft: int, hop: int, win_len: int, n_frames: int, device: torch.device):
    """(W [total], shifted windows [n_frames + 1, total]) on `device`.

    Row s of the second holds W shifted right by (n_frames - s)*hop with
    zeros in front, so row n_frames - nf is the subtracted term for nf
    valid frames (a strided view of one padded copy of W)."""
    total = hop * (n_frames - 1) + n_fft
    Wnp = _wss_semi_infinite(n_fft, hop, win_len, total)
    W = torch.from_numpy(Wnp).to(device)
    Wpad = torch.cat([W.new_zeros(hop * n_frames), W])
    return W, Wpad.unfold(0, total, hop)


def istft(
    real: torch.Tensor,
    imag: torch.Tensor,
    length: torch.Tensor,
    cfg: StftConfig,
    out_len: int,
) -> torch.Tensor:
    """Inverse STFT -> [B, out_len] buffers; samples beyond `length` are zero.

    librosa.istft semantics: inverse transform each frame, window,
    overlap-add, divide by window-sum-square, trim `pad`, cut to `length`.
    real/imag: [B, max_frames, n_bins]; the caller zeroes invalid frames.
    """
    max_frames = real.shape[1]
    fr = torch.fft.irfft(torch.complex(real, imag), n=cfg.n_fft, dim=-1)
    fr = fr * window_tensor(cfg.n_fft, cfg.win, real.device)
    ola = _overlap_add(fr, cfg.hop)
    # The window-sum-square counts only the valid frames (< nf), or the
    # tail of a bucketed signal is normalized as if ghost frames contributed.
    nf = n_frames_for_length(cfg, length.to(torch.int64))
    W, shifted = _wss_tensors(cfg.n_fft, cfg.hop, cfg.win, max_frames, real.device)
    wss = W[None, :] - shifted[torch.clamp(max_frames - nf, min=0)]
    ok = wss > 1e-10
    ola = torch.where(ok, ola / torch.where(ok, wss, torch.ones_like(wss)), ola)
    y = ola[:, cfg.pad : cfg.pad + out_len]
    if y.shape[1] < out_len:
        y = F.pad(y, (0, out_len - y.shape[1]))
    mask = torch.arange(out_len, device=y.device)[None, :] < length[:, None]
    return torch.where(mask, y, torch.zeros_like(y))
