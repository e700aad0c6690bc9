"""Reference-compatible `AudioMetrics` facade over the metric kernels.

API parity with reference ssr_eval/metrics.py:15-132:
    AudioMetrics(rate).evaluation(est, target, file) ->
        {"lsd": float, "log_sispec": float, "sispec": float, "ssim": float}

accepting either two 1-D numpy arrays or two file paths (decoded at the
evaluation rate, mono).  Inputs are validated with the reference's
invariants (|len diff| < 100, 1-D shapes — metrics.py:82-87,71-75).

precision="float32" pads each pair into a length bucket and scores it with
the batched kernels of `metrics.kernels` on `device` (None is the card,
"cpu" the CPU); precision="float64" runs the host NumPy formulas of
`metrics.host_reference`.  Batch work should call `metrics.kernels`
directly, as the harness does.
"""

from __future__ import annotations

import numpy as np
import torch

from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.dsp.spectral import stft_magnitude
from ssr_eval_tpu_torch.metrics.kernels import _ssim, metric_stft_config, spectral_metrics
from ssr_eval_tpu_torch.utils.bucket import bucket_length
from ssr_eval_tpu_torch.utils.common import energy_unify, pow_p_norm

METRIC_KEYS = ("lsd", "log_sispec", "sispec", "ssim")


class AudioMetrics:
    def __init__(self, rate, precision="float32", *, device=None):
        """precision: 'float32' (the batched kernels on `device`) or
        'float64' (host NumPy, the exact-precision cross-check — PARITY.md
        deviation 4; it needs no device)."""
        if precision not in ("float32", "float64"):
            raise ValueError(f"precision must be 'float32' or 'float64', got {precision!r}")
        self.rate = int(rate)
        self.precision = precision
        self.device = resolve_device(device) if precision == "float32" else torch.device("cpu")
        # Kept as public attributes for reference parity (metrics.py:17-19).
        self.hop_length = int(rate / 100)
        self.n_fft = int(2048 / (44100 / rate))

    def read(self, est, target):
        from ssr_eval_tpu_torch.io.audio import load

        est_wav, _ = load(est, sr=self.rate, mono=True)
        target_wav, _ = load(target, sr=self.rate, mono=True)
        return est_wav, target_wav

    def _row(self, wav, lmax):
        """1-D numpy -> ([1, lmax] tensor on the device, its length [1])."""
        buf = np.zeros((1, lmax), np.float32)
        buf[0, : len(wav)] = wav
        return torch.from_numpy(buf).to(self.device), torch.tensor([len(wav)], device=self.device)

    def wav_to_spectrogram(self, wav):
        """[1, 1, T, F] magnitude spectrogram (layout parity, metrics.py:26-30)."""
        wav = np.asarray(wav, dtype=np.float32)
        cfg = metric_stft_config(self.rate)
        x, n = self._row(wav, len(wav))
        sp = stft_magnitude(x, n, cfg, cfg.max_frames(len(wav)))
        return sp.cpu().numpy()[:, None]

    def center_crop(self, x, y):
        """Center-crop the longer of two [., ., T, F] spectrogram arrays to
        the shorter's time length (reference metrics.py:32-49; unused by
        the pipeline but part of the public surface).  Accepts numpy."""
        x = np.asarray(x)
        y = np.asarray(y)
        dim = 2
        if x.shape[dim] == y.shape[dim]:
            return x, y
        if x.shape[dim] > y.shape[dim]:
            offset = x.shape[dim] - y.shape[dim]
            start = offset // 2
            end = offset - start
            x = x[:, :, start:-end, :]
        else:
            offset = y.shape[dim] - x.shape[dim]
            start = offset // 2
            end = offset - start
            y = y[:, :, start:-end, :]
        assert offset < 10, (
            "Error: the offset %s is too large, check the code please" % (offset)
        )
        return x, y

    # -- per-metric public surface (reference metrics.py:109-132) --------
    # Spectrogram-level conveniences on [B, C, T, F] arrays (the layout
    # wav_to_spectrogram emits); numpy or torch tensors in, numpy out.

    @staticmethod
    def _np4(x):
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        x = np.asarray(x, dtype=np.float32)
        assert x.ndim == 4, f"expected [B, C, T, F], got {x.shape}"
        return x

    def lsd(self, est, target):
        """[B, C, 1, 1] log-spectral distance (metrics.py:109-112)."""
        est, target = self._np4(est), self._np4(target)
        r = np.log10(target**2 / ((est + 1e-12) ** 2) + 1e-12) ** 2
        return np.mean(np.sqrt(np.mean(r, axis=3)), axis=2)[..., None, None]

    def sispec(self, est, target):
        """Batch-summed scale-invariant spectral SNR (metrics.py:114-121)."""
        est, target = self._np4(est), self._np4(target)
        out, tgt = energy_unify(est, target)
        noise = out - tgt
        loss = 10.0 * np.log10(pow_p_norm(tgt) / (pow_p_norm(noise) + 1e-12) + 1e-12)
        return float(np.sum(loss) / loss.shape[0])

    def ssim(self, est, target):
        """[B, C, 1, 1] mean SSIM per (batch, channel), skimage-default
        semantics through the batched box-moment kernel (metrics.py:123-132)."""
        est, target = self._np4(est), self._np4(target)
        B, C, T, F = est.shape
        X = torch.from_numpy(est.reshape(B * C, T, F)).to(self.device)
        Y = torch.from_numpy(target.reshape(B * C, T, F)).to(self.device)
        s = _ssim(X, Y, torch.full((B * C,), T, device=self.device))
        return s.double().cpu().numpy().reshape(B, C)[..., None, None]

    def evaluation(self, est, target, file=None):
        if type(est) != type(target) and not (
            isinstance(est, np.ndarray) and isinstance(target, np.ndarray)
        ):
            raise ValueError(
                "The input value should either both be numpy array or strings"
            )
        if isinstance(est, str):
            est_wav, target_wav = self.read(est, target)
        else:
            assert est.ndim == 1 and target.ndim == 1, (
                "The input numpy array shape should be [samples,]. "
                f"Got input shape {est.shape} and {target.shape}. "
            )
            est_wav, target_wav = est, target

        assert abs(target_wav.shape[0] - est_wav.shape[0]) < 100, (
            "Error: Shape mismatch between target and estimation "
            f"{target_wav.shape} and {est_wav.shape}"
        )

        if self.precision == "float64":
            from ssr_eval_tpu_torch.metrics.host_reference import evaluate_f64

            return evaluate_f64(est_wav, target_wav, self.rate)

        lmax = bucket_length(max(est_wav.shape[0], target_wav.shape[0]))
        e, ne = self._row(np.asarray(est_wav, np.float32), lmax)
        t, nt = self._row(np.asarray(target_wav, np.float32), lmax)
        cfg = metric_stft_config(self.rate)
        out = spectral_metrics(e, ne, t, nt, cfg, cfg.max_frames(lmax))
        return {k: float(out[k][0]) for k in METRIC_KEYS}
