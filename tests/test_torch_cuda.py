"""Tests of ssr_eval_tpu_torch that need a CUDA card (marker `cuda`); each
skips itself on a machine without one.  This file imports neither jax nor
the JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the |STFT| kernel (a float32 shared-memory FFT) within 1e-4
of the largest magnitude of its plain version and within 2e-6 of it
against a float64 rfft (float32 FFTs round at ~2e-7); a sweep on the card
within LSD 2.5e-4, log-SiSpec 2e-3, SiSpec 5e-5 dB and SSIM 1e-6 of the
same sweep on the CPU (chip_smoke.py's limits).
"""

import numpy as np
import pytest
import torch

from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.dsp.spectral import window_tensor
from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel, stft_magnitude_plain
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.harness.testee import BatchedTestee, state_from_numpy
from ssr_eval_tpu_torch.io.audio import write_wav

CARD_VS_CPU = {"lsd": 2.5e-4, "log_sispec": 2e-3, "sispec": 5e-5, "ssim": 1e-6}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_fft,hop,rows",
    [
        (2048, 441, 4), (2229, 480, 4), (743, 160, 4), (4096, 1024, 4), (17, 5, 4),
        # the split path's ends and the Bluestein lengths' jumps (fft_len
        # 1 -> 1, 2047 -> 4096, 2049 -> 4096, 2732 -> 8192, 4095 -> 8192)
        (1, 1, 4), (2, 1, 4), (2047, 400, 4), (2049, 400, 4), (2732, 500, 4), (4095, 1000, 4),
        # 3 x 37 frames: a ragged last block wherever a block holds >= 2 frames
        (2048, 441, 3), (743, 160, 3), (17, 5, 3),
    ],
)
def test_cuda_kernel_matches_plain(card, n_fft, hop, rows):
    mf = 37
    g = torch.Generator().manual_seed(n_fft)
    ext = torch.randn(rows, (mf - 1) * hop + n_fft + 13, generator=g).to(card)
    win = window_tensor(n_fft, n_fft, card) if n_fft > 1 else torch.ones(1, device=card)
    before = stft_magnitude_kernel.launches
    got = stft_magnitude_kernel(ext, n_fft, hop, mf, win)
    torch.cuda.synchronize()
    assert stft_magnitude_kernel.launches == before + 1
    want = stft_magnitude_plain(ext, n_fft, hop, mf, win)
    assert got.shape == want.shape == (rows, mf, n_fft // 2 + 1)
    assert ((got - want).abs().max() / want.abs().max()).item() < 1e-4
    fr = ext.double().unfold(-1, n_fft, hop)[:, :mf, :]
    ref = torch.fft.rfft(fr * win.double(), dim=-1).abs()
    assert ((got.double() - ref).abs().max() / ref.abs().max()).item() <= 2e-6


class NoisyTestee(BatchedTestee):
    def __init__(self, state):
        self.state = state

    def device_state(self):
        return self.state

    def infer_batch(self, x, lengths, state=None):
        ar = torch.arange(x.shape[1], device=x.device)
        mask = (ar[None, :] < lengths[:, None]).to(torch.float32)
        return x.to(torch.float32) + state[ar % state.shape[0]][None, :] * mask, lengths


@pytest.mark.cuda
@pytest.mark.parametrize("eval_sr", [44100, 48000])
def test_sweep_on_card_matches_cpu(card, eval_sr, tmp_path):
    paths = []
    for i, dur in enumerate([0.5, 0.8, 1.1]):
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, speechlike(dur, 48000, seed=60 + i), 48000)
        paths.append(p)
    specs = expand_settings(setting_fft={"cutoff_freq": [4000, 16000]}, sr=44100)
    noise = (1e-3 * np.random.default_rng(777).standard_normal(1 << 17)).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        eng = EvalEngine(
            specs, 44100, 44100, eval_sr, NoisyTestee(state_from_numpy(noise, dev)),
            batch_size=2, device=dev,
        )
        out[dev] = eng.evaluate_files(paths)
    for p in paths:
        for s in specs:
            for k, tol in CARD_VS_CPU.items():
                a, b = out["cuda"][p][s.key][k], out["cpu"][p][s.key][k]
                assert np.isfinite(a) and abs(a - b) <= tol, (p, s.key, k, a, b)
