"""`FDomainHelper` — reference-compatible STFT utility surface
(reference ssr_eval/dsp.py:6-183).

The reference wraps torchlibrosa STFT/ISTFT modules; here the same public
methods are thin conveniences over the package's one STFT core
(dsp/spectral.py), on numpy arrays or tensors shaped [batch, channels,
samples], returning numpy [batch, channels, T, F] (and inverses), like the
original:

    spectrogram, spectrogram_phase, wav_to_spectrogram,
    wav_to_spectrogram_phase, spectrogram_phase_to_wav,
    complex_spectrogram, reverse_complex_spectrogram,
    wav_to_complex_spectrogram, complex_spectrogram_to_wav,
    spectrogram_to_wav

Configuration is an immutable `StftConfig`, so instances are shareable
across threads (the reference kept a mutable module-global helper,
lowpass.py:14,107-109).  The transforms run on `device` (None is the card,
"cpu" the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.dsp.spectral import (
    StftConfig,
    istft,
    n_frames_for_length,
    stft_real_imag,
)
from ssr_eval_tpu_torch.utils.bucket import bucket_length


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=np.float32)


class FDomainHelper:
    """STFT defaults match the reference: window 2048, hop 441, hann,
    center=True reflect padding (dsp.py:7-17).  `subband` divides the
    sizes (dsp.py:40-59)."""

    def __init__(
        self,
        window_size=2048,
        hop_size=441,
        center=True,
        pad_mode="reflect",
        window="hann",
        freeze_parameters=True,
        subband=None,
        *,
        device=None,
    ):
        if window != "hann" or pad_mode != "reflect":
            raise ValueError("FDomainHelper supports hann/reflect (reference defaults)")
        self.subband = subband
        div = subband if subband else 1
        self.cfg = StftConfig(n_fft=window_size // div, hop=hop_size // div, center=center)
        self.device = resolve_device(device)

    # -- internals -----------------------------------------------------

    def _stft_rows(self, x2d):
        """[N, samples] (equal lengths) -> (real, imag [N, T, F], n_frames)."""
        x2d = _np(x2d)
        N, L = x2d.shape
        lmax = bucket_length(L)
        buf = np.zeros((N, lmax), np.float32)
        buf[:, :L] = x2d
        length = torch.full((N,), L, device=self.device)
        r, i = stft_real_imag(
            torch.from_numpy(buf).to(self.device), length, self.cfg, self.cfg.max_frames(lmax)
        )
        nf = int(n_frames_for_length(self.cfg, L))
        return r[:, :nf].cpu().numpy(), i[:, :nf].cpu().numpy(), nf

    def _istft_bc(self, real, imag, length):
        B, C, T, F = real.shape
        out_len = bucket_length(length)
        nf = n_frames_for_length(self.cfg, length)
        m = (np.arange(T) < nf)[:, None].astype(np.float32)
        dev = self.device
        y = istft(
            torch.from_numpy(np.ascontiguousarray(real.reshape(B * C, T, F) * m)).to(dev),
            torch.from_numpy(np.ascontiguousarray(imag.reshape(B * C, T, F) * m)).to(dev),
            torch.full((B * C,), length, device=dev),
            self.cfg,
            out_len,
        )
        return y[:, :length].cpu().numpy().reshape(B, C, length)

    # -- reference API -------------------------------------------------

    def spectrogram(self, input, eps=0.0):
        """[B, samples] -> [B, 1, T, F] magnitude (dsp.py:72-74)."""
        r, i, _ = self._stft_rows(input)
        return np.sqrt(np.clip(r * r + i * i, eps, np.inf))[:, None]

    def spectrogram_phase(self, input, eps=0.0):
        """[B, samples] -> (mag, cos, sin) each [B, 1, T, F] (dsp.py:76-81)."""
        r, i, _ = self._stft_rows(input)
        mag = np.sqrt(np.clip(r * r + i * i, eps, np.inf))
        return mag[:, None], (r / mag)[:, None], (i / mag)[:, None]

    def wav_to_spectrogram_phase(self, input, eps=1e-8):
        """[B, C, samples] -> (sps, coss, sins) [B, C, T, F] (dsp.py:83-105)."""
        input = _np(input)
        B, C, L = input.shape
        r, i, _ = self._stft_rows(input.reshape(B * C, L))
        mag = np.sqrt(np.clip(r * r + i * i, eps, np.inf))
        shape = (B, C) + mag.shape[1:]
        return mag.reshape(shape), (r / mag).reshape(shape), (i / mag).reshape(shape)

    def wav_to_spectrogram(self, input, eps=1e-8):
        """[B, C, samples] -> [B, C, T, F] magnitudes (dsp.py:121-135)."""
        input = _np(input)
        B, C, L = input.shape
        r, i, _ = self._stft_rows(input.reshape(B * C, L))
        mag = np.sqrt(np.clip(r * r + i * i, eps, np.inf))
        return mag.reshape((B, C) + mag.shape[1:])

    def spectrogram_phase_to_wav(self, sps, coss, sins, length):
        """(mag, cos, sin) [B, C, T, F] -> [B, C, length] (dsp.py:107-119)."""
        sps = _np(sps)
        return self._istft_bc(sps * _np(coss), sps * _np(sins), length)

    def complex_spectrogram(self, input, eps=0.0):
        """[B, samples] -> [B, 2, T, F] (real, imag) (dsp.py:61-65)."""
        r, i, _ = self._stft_rows(input)
        return np.stack([r, i], axis=1)

    def reverse_complex_spectrogram(self, input, eps=0.0, length=None):
        """[B, 2, T, F] -> [B, length] (dsp.py:67-70)."""
        input = _np(input)
        return self._istft_bc(input[:, 0:1], input[:, 1:2], length)[:, 0]

    def wav_to_complex_spectrogram(self, input, eps=0.0):
        """[B, C, samples] -> [B, 2C, T, F] (dsp.py:162-169)."""
        input = _np(input)
        B, C, L = input.shape
        r, i, _ = self._stft_rows(input.reshape(B * C, L))
        r = r.reshape((B, C) + r.shape[1:])
        i = i.reshape((B, C) + i.shape[1:])
        # interleave (real_c, imag_c) pairs along the channel axis
        return np.stack([r, i], axis=2).reshape((B, 2 * C) + r.shape[2:])

    def complex_spectrogram_to_wav(self, input, eps=0.0, length=None):
        """[B, 2C, T, F] -> [B, C, length] (dsp.py:171-183)."""
        input = _np(input)
        C = input.shape[1] // 2
        return np.stack(
            [
                self.reverse_complex_spectrogram(input[:, 2 * c : 2 * c + 2], length=length)
                for c in range(C)
            ],
            axis=1,
        )

    def spectrogram_to_wav(self, input, spectrogram, length=None):
        """Swap `input`'s magnitudes for `spectrogram`'s, keep phases
        (dsp.py:137-159).  input [B, C, samples], spectrogram [B, C, T, F]."""
        _, cos, sin = self.wav_to_spectrogram_phase(input, eps=1e-8)
        spectrogram = _np(spectrogram)
        return self._istft_bc(spectrogram * cos, spectrogram * sin, length)
