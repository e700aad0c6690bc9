"""Training data pipeline: HR audio -> (LR mel, HR mel) pairs on the device.

Counterpart of ``ssr_eval_tpu.models.data``.  NVSR-style generators train on
mel pairs made by the same degradations the evaluator applies, so the
pipeline reuses the port's degradation and |STFT| kernel:

    hr wav [B, L] --degrade(fft spec, cycling the cutoffs)--> lr wav
                  --|STFT|(2048/441, eps 1e-8) + mel fbanks--> (mel_lr, mel_hr)

Crops have one fixed length, so every batch has one shape.  The JAX
package's `vmap` over the batch is the batch dimension written out.  Two
|STFT| kernel launches per batch (HR and LR).
"""

from __future__ import annotations

import numpy as np
import torch

from ssr_eval_tpu_torch.degrade.apply import build_family_degrader, family_key, spec_params
from ssr_eval_tpu_torch.degrade.plan import DegradationSpec
from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.dsp.spectral import stft_magnitude
from ssr_eval_tpu_torch.models.mel import MelScale
from ssr_eval_tpu_torch.models.nvsr import NVSR_STFT


class MelPairPipeline:
    """Degrade-and-melify batches for generator training.  device: None is
    the CUDA card (raises without one), "cpu" the CPU."""

    def __init__(self, sr=44100, crop_seconds=1.0, n_mels=128, cutoffs=(2000, 4000, 8000, 12000), device=None):
        self.device = resolve_device(device)
        self.sr = sr
        self.crop = int(crop_seconds * sr)
        self.specs = [
            DegradationSpec(f"train_fft_{c}", "fft", None, 2 * c, 1, sr) for c in cutoffs
        ]
        self.mel = MelScale(n_mels=n_mels, sample_rate=sr, n_stft=NVSR_STFT.n_bins).to(self.device)

    @torch.no_grad()
    def make_pair(self, wav_batch: np.ndarray, spec_idx: int):
        """wav_batch [B, crop] float32 -> (mel_lr, mel_hr) [B, T, M] on the
        device."""
        spec = self.specs[spec_idx % len(self.specs)]
        deg = build_family_degrader(family_key(spec), self.crop)
        x = torch.as_tensor(np.asarray(wav_batch, np.float32)).to(self.device)
        length = torch.full((x.shape[0],), self.crop, dtype=torch.int64, device=self.device)
        mf = NVSR_STFT.max_frames(self.crop)
        lr = deg(x, length, spec_params(spec, self.crop, self.device))
        sp_hr = stft_magnitude(x, length, NVSR_STFT, mf, eps=1e-8)
        sp_lr = stft_magnitude(lr, length, NVSR_STFT, mf, eps=1e-8)
        return self.mel(sp_lr), self.mel(sp_hr)

    def random_crops(self, audios, rng: np.random.Generator, batch: int):
        """Sample fixed-size crops from variable-length host audio."""
        return random_crops(audios, rng, batch, self.crop)


def random_crops(audios, rng: np.random.Generator, batch: int, crop: int) -> np.ndarray:
    """[batch, crop] float32 crops of randomly drawn host clips (a clip no
    longer than `crop` is zero-padded), drawn with the JAX package's rng
    calls in its order."""
    out = np.zeros((batch, crop), np.float32)
    for i in range(batch):
        x = audios[rng.integers(len(audios))]
        if len(x) <= crop:
            out[i, : len(x)] = x
        else:
            s = rng.integers(len(x) - crop)
            out[i] = x[s : s + crop]
    return out
