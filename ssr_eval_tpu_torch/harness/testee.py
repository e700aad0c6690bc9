"""Testee plugin surface.

`BasicTestee` keeps API parity with the reference (eval.py:17-52): a
single-utterance `infer(x: np.ndarray) -> np.ndarray` (optionally
`(np.ndarray, dict)` for extra per-utterance metrics — the tuple protocol
at eval.py:139-143 is public API), plus the cutoff-detection and low-band
splice `postprocessing` helpers (eval.py:21-41), which run on the testee's
`device` (None is the card, "cpu" the CPU).  The engine bridges `infer`
through host numpy.

`BatchedTestee` runs on the device: `infer_batch(x [B, Lmax], lengths [B],
state) -> ([B, Lout], out_lengths)` on tensors, so the engine keeps
degrade -> infer -> metrics on the card.  Weights or other arrays a
testee needs come from `device_state()`; the engine moves them to its
device and passes them back as `state`.
"""

from __future__ import annotations

import numpy as np
import torch

from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.dsp.spectral import (
    StftConfig,
    istft,
    n_frames_for_length,
    stft_magnitude,
    stft_real_imag,
)
from ssr_eval_tpu_torch.utils.bucket import pow2_bucket

# librosa.stft defaults, used by the reference's cutoff detection and
# postprocessing splice (eval.py:29,37-40).
_POSTPROC_STFT = StftConfig(n_fft=2048, hop=512)



def state_from_numpy(state, device):
    """A nested dict/list/tuple of arrays -> the same structure of torch
    tensors on `device` (tensors are moved, None stays None).

    Carries a testee's state across from another framework, e.g. the JAX
    package's `device_state()` after `np.asarray`."""
    if state is None:
        return None
    if isinstance(state, dict):
        return {k: state_from_numpy(v, device) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(state_from_numpy(v, device) for v in state)
    if isinstance(state, torch.Tensor):
        return state.to(device)
    return torch.tensor(np.asarray(state), device=device)


def _state_device(state):
    """The device of the first tensor in a state structure, else the CPU."""
    if isinstance(state, torch.Tensor):
        return state.device
    if isinstance(state, dict):
        state = list(state.values())
    if isinstance(state, (list, tuple)):
        for v in state:
            d = _state_device(v)
            if d.type != "cpu":
                return d
    return torch.device("cpu")


class BasicTestee:
    """Identity testee + reference helper methods (eval.py:17-52)."""

    #: Where `postprocessing` and `_get_cutoff_index` run.
    device = None

    def __init__(self) -> None:
        pass

    def _find_cutoff(self, x, threshold=0.95):
        """Largest index whose cumulative energy is below threshold*x[-1]
        (vectorized equivalent of the reference loop, eval.py:21-26)."""
        x = np.asarray(x)
        thr = x[-1] * threshold
        below = np.nonzero(x < thr)[0]
        return int(below[-1]) if below.size else 0

    def _rows(self, *signals):
        """1-D numpy signals -> [n, bucket] tensor on the testee's device,
        their lengths [n], the bucket."""
        dev = resolve_device(self.device)
        lmax = pow2_bucket(max(len(s) for s in signals))
        buf = np.zeros((len(signals), lmax), np.float32)
        for j, s in enumerate(signals):
            buf[j, : len(s)] = s
        lengths = torch.tensor([len(s) for s in signals], device=dev)
        return torch.from_numpy(buf).to(dev), lengths, lmax

    def _get_cutoff_index(self, x):
        x = np.asarray(x, dtype=np.float32)
        xb, n, lmax = self._rows(x)
        cfg = _POSTPROC_STFT
        mf = cfg.max_frames(lmax)
        mag = stft_magnitude(xb, n, cfg, mf)[0]  # [T, F]
        fmask = (torch.arange(mf, device=xb.device) < n_frames_for_length(cfg, n)[0]).to(mag.dtype)
        energy = torch.cumsum(torch.sum(mag * fmask[:, None], dim=0), dim=0)
        return self._find_cutoff(energy.cpu().numpy(), 0.97)

    def postprocessing(self, x, out):
        """Replace the low band of `out` with ground truth `x` below the
        detected cutoff bin, then resynthesize at out's length
        (eval.py:33-41)."""
        x = np.asarray(x, dtype=np.float32)
        out = np.asarray(out, dtype=np.float32)
        cutoff_bin = self._get_cutoff_index(x)
        both, n, lmax = self._rows(x, out)
        cfg = _POSTPROC_STFT
        mf = cfg.max_frames(lmax)
        real, imag = stft_real_imag(both, n, cfg, mf)
        low = torch.arange(cfg.n_bins, device=both.device)[None, :] < cutoff_bin
        real = torch.where(low, real[0], real[1])
        imag = torch.where(low, imag[0], imag[1])
        nf = n_frames_for_length(cfg, n[1:])
        fmask = (torch.arange(mf, device=both.device) < nf[0]).to(real.dtype)[:, None]
        y = istft((real * fmask)[None], (imag * fmask)[None], n[1:], cfg, lmax)
        return y[0, : out.shape[0]].cpu().numpy()

    def tensor2numpy(self, tensor):
        """torch tensors (cuda-aware, eval.py:43-47), or anything numpy
        takes -> numpy."""
        if isinstance(tensor, torch.Tensor):
            return tensor.detach().cpu().numpy()
        return np.asarray(tensor)

    def infer(self, x):
        # x: [samples,] -> [samples,]
        return x


class BatchedTestee(BasicTestee):
    """Device testee: override `infer_batch` (and `device_state` for any
    arrays it reads).  The default is identity."""

    def device_state(self):
        """Nested structure of arrays/tensors passed to `infer_batch`."""
        return None

    def infer_batch(self, x: torch.Tensor, lengths: torch.Tensor, state=None):
        """x: [B, Lmax] at model_input_sr -> ([B, Lout], out_lengths [B])."""
        return x, lengths

    def infer(self, x):
        """Single-utterance bridge through the batched path (runs where the
        state lives; the CPU for a stateless testee)."""
        state = self.device_state()
        dev = _state_device(state)
        arr = torch.as_tensor(np.asarray(x, dtype=np.float32)[None, :], device=dev)
        y, ls = self.infer_batch(arr, torch.tensor([arr.shape[1]], device=dev), state)
        return y[0, : int(ls[0])].detach().cpu().numpy()
