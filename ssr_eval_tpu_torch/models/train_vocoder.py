"""Vocoder training: mel -> waveform with a spectral reconstruction loss.

Counterpart of ``ssr_eval_tpu.models.train_vocoder`` (the reference ships a
pretrained voicefixer vocoder and never trains one): train a (small)
TFGAN-structure vocoder on synthetic speech until its synthesis follows its
mel conditioning, then export it as a voicefixer-layout torch state dict
that `NVSRTestee.load_vocoder_checkpoint` reads back through the real
conversion path.

Loss, over interior frames: spectral convergence ||o - t|| / (||t|| +
1e-6) of the linear mels plus 0.5 x the mean |log-mel difference|.  The mel
of the synthesis goes through the evaluator's own front end (|STFT|
2048/441 with eps 1e-8, HTK fbanks), so on the card its gradient goes
through the hand-written backward of the |STFT| kernel: one forward and one
backward launch per step (the conditioning's |STFT| adds one more forward).

JAX's state is immutable; here the state holds the vocoder module and its
optimizer, and `step` updates both in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.dsp.spectral import stft_magnitude
from ssr_eval_tpu_torch.models.data import random_crops
from ssr_eval_tpu_torch.models.mel import MelScale
from ssr_eval_tpu_torch.models.nvsr import NVSR_STFT, init_weights, to_log
from ssr_eval_tpu_torch.models.train import adamw
from ssr_eval_tpu_torch.models.vocoder import TFGANConfig, Vocoder

# Small-but-real preset for offline training (the JAX package's): the
# 441 = 7*7*3*3 hop, halved dilated-stack depth, 96 base channels.
SMALL_TFGAN = TFGANConfig(channels=96, res_dilations=(1, 3))


def _interior(T):
    return (2, T - 2) if T > 8 else (0, T)


class VocoderTrainer:
    """Train a TFGAN-structure vocoder with a log-mel reconstruction loss.
    device: None is the CUDA card (raises without one), "cpu" the CPU."""

    def __init__(self, cfg: TFGANConfig = SMALL_TFGAN, sample_rate=44100, learning_rate=2e-4, device=None):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.sample_rate = sample_rate
        self.learning_rate = learning_rate
        self.model = Vocoder(cfg)
        self.mel = MelScale(n_mels=cfg.n_mels, sample_rate=sample_rate, n_stft=NVSR_STFT.n_bins).to(self.device)

    def lin_mel(self, wav_b):
        """[B, L] -> linear mel [B, T, M] (differentiable)."""
        B, L = wav_b.shape
        length = torch.full((B,), L, dtype=torch.int64, device=wav_b.device)
        return self.mel(stft_magnitude(wav_b, length, NVSR_STFT, NVSR_STFT.max_frames(L), eps=1e-8))

    def log_mel(self, wav_b):
        """[B, L] -> log-mel [B, T, M] via the evaluator's own front end."""
        return to_log(self.lin_mel(wav_b))

    def init_state(self, seed: int = 0, params=None):
        """{"model": the vocoder on the device, "opt": its AdamW}.  Weights:
        `params`, the JAX package's Vocoder params ({"model": {"pre": ...}}
        as NumPy arrays), else `nvsr.init_weights(seed)`, flax's default
        draw (truncated LeCun normal kernels, zero biases)."""
        if params is not None:
            from ssr_eval_tpu_torch.models.convert import nvsr_state_from_flax

            self.model.load_state_dict(nvsr_state_from_flax({"params": params}))
        else:
            init_weights(self.model, seed)
        self.model.to(self.device).train()
        return {"model": self.model, "opt": adamw(self.model.parameters(), self.learning_rate)}

    def loss(self, model, cond_mel, target_mel):
        """Spectral convergence + 0.5 log-L1 of the synthesis' mel against
        `target_mel`, over interior frames."""
        out = self.lin_mel(model(cond_mel))
        lo, hi = _interior(min(out.shape[1], target_mel.shape[1]))
        o, t = out[:, lo:hi], target_mel[:, lo:hi]
        # Spectral convergence weights the high-energy structure (log-L1
        # alone over-weights silent bands and collapses to a noise floor);
        # log-L1 keeps the floors and dynamics.
        sc = torch.linalg.norm(o - t) / (torch.linalg.norm(t) + 1e-6)
        return sc + 0.5 * torch.mean(torch.abs(to_log(o) - to_log(t)))

    def step(self, state, cond_mel, target_mel):
        """One AdamW step -> (state, loss as a 0-d tensor on the device)."""
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        loss = self.loss(state["model"], cond_mel, target_mel)
        loss.backward()
        opt.step()
        return state, loss.detach()

    def fit(self, audios, steps=300, batch=4, crop_seconds=0.35, seed=0, log_every=25, state=None):
        """audios: list of HR float32 waveforms at `sample_rate`.

        Returns (state, losses); pass the state back in to continue training.
        The conditioning is the target's own linear mel (the vocoder
        resynthesizes; the generator owns bandwidth extension)."""
        crop = int(crop_seconds * self.sample_rate)
        rng = np.random.default_rng(seed)
        if state is None:
            state = self.init_state(seed)
        losses = []
        for step_i in range(steps):
            with torch.no_grad():
                cond = self.lin_mel(torch.from_numpy(random_crops(audios, rng, batch, crop)).to(self.device))
            state, loss = self.step(state, cond, cond)
            losses.append(float(loss))
            if log_every and step_i % log_every == 0:
                print(f"[vocoder] step {step_i} loss {losses[-1]:.4f}", flush=True)
        return state, losses

    @torch.no_grad()
    def probe_corr(self, model, wav: np.ndarray) -> float:
        """Pearson correlation between `wav`'s own log-mel conditioning and
        the log-mel of the synthesis from it (interior frames): the quantity
        models/vocoder_check.py gates on at load time."""
        x = torch.as_tensor(np.asarray(wav, np.float32))[None].to(self.device)
        cond = self.lin_mel(x)
        out_lm = self.log_mel(model(cond))[0].cpu().numpy()
        cond_lm = to_log(cond)[0].cpu().numpy()
        lo, hi = _interior(min(out_lm.shape[0], cond_lm.shape[0]))
        a = cond_lm[lo:hi].ravel().astype(np.float64)
        b = out_lm[lo:hi].ravel().astype(np.float64)
        a -= a.mean()
        b -= b.mean()
        denom = float(np.sqrt((a * a).sum() * (b * b).sum()))
        return 0.0 if denom == 0.0 else float((a * b).sum() / denom)


def export_torch_state_dict(model, cfg: TFGANConfig, path: str):
    """A port `Vocoder` -> voicefixer-layout torch state dict (plain
    `weight` / `bias`, generator.* Sequential names) saved at `path`
    (`convert.voicefixer_state_from_vocoder`).  Returns the dict."""
    from ssr_eval_tpu_torch.models.convert import voicefixer_state_from_vocoder

    sd = voicefixer_state_from_vocoder(model, cfg)
    torch.save(sd, path)
    return sd
