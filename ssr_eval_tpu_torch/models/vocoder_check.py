"""Load-time sanity check for grafted vocoder checkpoints.

Dilation values and the mel-normalization constants (min_db / max_abs /
ref_db) leave no trace in a state dict's tensor SHAPES, so a checkpoint
from a vocoder trained with different values would load with zero
unmatched tensors and synthesize wrong audio with no error.  After
grafting, synthesize from a probe signal's own mel and require that the
synthesized audio's mel CORRELATES with the conditioning: true for any
usable trained vocoder, false for a misplaced or mis-normalized
reconstruction (whose output is noise with respect to the conditioning).

A random-initialized vocoder fails the check by construction, which is
what the trip-wire test relies on; loads of random mirrors pass
``check=False``.  The check runs on the model's own device.

Reference context: the reference loads voicefixer's pretrained vocoder
blindly (examples/NVSR/nvsr_unet.py:84); it has no equivalent check.
"""

from __future__ import annotations

import numpy as np
import torch


class VocoderSanityError(RuntimeError):
    """Grafted vocoder synthesizes audio unrelated to its conditioning."""


def probe_signal(sr: int, seconds: float = 0.35) -> np.ndarray:
    """Deterministic speech-like probe: a vibrato'd harmonic stack under a
    Hann envelope — broad mel-band structure that varies over time, so the
    conditioning/output correlation is well-conditioned."""
    L = int(seconds * sr)
    t = np.arange(L, dtype=np.float64) / sr
    f0 = 150.0 + 40.0 * np.sin(2.0 * np.pi * 2.5 * t)
    phase = 2.0 * np.pi * np.cumsum(f0) / sr
    x = sum((0.5 / k) * np.sin(k * phase) for k in range(1, 6))
    return (0.5 * x * np.hanning(L)).astype(np.float32)


def _device(model) -> torch.device:
    return next(model.parameters()).device


def _mel_of(model, wav) -> torch.Tensor:
    """Log-mel [T, M] of a 1-D waveform through the model's own front end."""
    from ssr_eval_tpu_torch.models.nvsr import NVSR_STFT, to_log

    dev = _device(model)
    wav = torch.as_tensor(wav, dtype=torch.float32).to(dev)
    L = int(wav.shape[0])
    _, mel = model.pre(wav[None], torch.tensor([L], device=dev), NVSR_STFT.max_frames(L))
    return to_log(mel[0])


def log_mel_correlation(model, cond_log_mel, wav) -> float:
    """Pearson correlation between a conditioning log-mel [T, M] and the
    log-mel of `wav` over the interior frames (edges are padding-affected).
    Constant inputs (e.g. an all-zero synthesis) correlate 0."""
    with torch.inference_mode():
        out = _mel_of(model, wav).cpu().numpy()
    cond = np.asarray(cond_log_mel.cpu() if isinstance(cond_log_mel, torch.Tensor) else cond_log_mel)
    T = min(cond.shape[0], out.shape[0])
    lo, hi = (2, T - 2) if T > 8 else (0, T)
    a = cond[lo:hi].ravel().astype(np.float64)
    b = out[lo:hi].ravel().astype(np.float64)
    a -= a.mean()
    b -= b.mean()
    denom = float(np.sqrt((a * a).sum() * (b * b).sum()))
    if denom == 0.0 or not np.isfinite(denom):
        return 0.0
    return float((a * b).sum() / denom)


def synthesis_report(model, seconds: float = 0.35) -> dict:
    """Synthesize from the probe's own mel with `model` (an eval-mode NVSR)
    on its device; report conditioning/output agreement."""
    with torch.inference_mode():
        x = probe_signal(model.sample_rate, seconds)
        cond = _mel_of(model, x)  # [T, M]
        y = model.synthesize(cond[None])[0].to(torch.float64).cpu().numpy()
        corr = log_mel_correlation(model, cond, y)
    return {
        "corr": corr,
        "rms": float(np.sqrt(np.mean(y * y))),
        "finite": bool(np.isfinite(y).all()),
        "n_samples": int(y.shape[0]),
    }


def check_vocoder(model, threshold: float = 0.5) -> dict:
    """Raise VocoderSanityError unless the grafted vocoder's synthesis is
    finite, non-silent, and mel-correlated (> threshold) with its
    conditioning.  Returns the report on success."""
    rep = synthesis_report(model)
    if not rep["finite"]:
        raise VocoderSanityError(
            f"vocoder synthesis contains non-finite samples ({rep})"
        )
    if rep["rms"] < 1e-6:
        raise VocoderSanityError(
            f"vocoder synthesis is silent (rms={rep['rms']:.2e}) — the "
            f"grafted weights do not produce audio ({rep})"
        )
    if rep["corr"] < threshold:
        raise VocoderSanityError(
            "vocoder synthesis does not follow its mel conditioning "
            f"(log-mel correlation {rep['corr']:.3f} < {threshold}) — the "
            "checkpoint's architecture constants (dilations / mel-norm "
            "min_db/max_abs/ref_db) likely differ from the reconstruction; "
            "pass an explicit TFGANConfig, or check=False to load anyway "
            f"({rep})"
        )
    return rep
