"""Tests of ssr_eval_tpu_torch that need a CUDA card (marker `cuda`); each
skips itself on a machine without one.  This file imports neither jax nor
the JAX package, so it also runs where only the port is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances: the |STFT| kernel (a float32 shared-memory FFT) within 1e-4
of the largest magnitude of its plain version and within 2e-6 of it
against a float64 rfft (float32 FFTs round at ~2e-7); the IIR degraders on
the card within 1e-5 of max|ref| of their CPU run and 1e-4 of scipy's
float64 sosfiltfilt; a sweep on the card within LSD 2.5e-4, log-SiSpec
2e-3, SiSpec 5e-5 dB and SSIM 1e-6 of the same sweep on the CPU
(chip_smoke.py's limits).
"""

import os

import numpy as np
import pytest
import torch
from scipy.signal import sosfiltfilt as scipy_sff

from ssr_eval_tpu_torch.degrade import apply as deg

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


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["blocked", "monolithic"])
def test_iir_degraders_on_card_match_cpu_and_scipy(card, path):
    from ssr_eval_tpu_torch.dsp.filters import complex_from_parts, design_lowpass_sos

    lengths, lmax = (20011, 14999), 24000
    rng = np.random.default_rng(5)
    x = np.zeros((2, lmax), np.float32)
    for j, n in enumerate(lengths):
        x[j, :n] = speechlike(1.0, 44100, seed=j)[:n] + 0.01 * rng.standard_normal(n)
    for name, ftype in (("butter", "butter"), ("cheby", "cheby1"), ("ellip", "ellip"), ("bessel", "bessel")):
        for order, cutoff in ((4, 2000), (8, 8000)):
            spec = expand_settings(
                setting_lowpass_filtering={"filter": [name], "cutoff_freq": [cutoff], "filter_order": [order]},
                sr=44100,
            )[0]
            key = deg.family_key(spec) if path == "blocked" else ("iir", None)
            out = []
            for dev in (card, torch.device("cpu")):
                if path == "blocked":
                    params = deg.spec_params(spec, lmax, dev)
                else:
                    a = deg.iir_host_arrays(spec, lmax, None)
                    params = {"edge": a["edge"], "H": complex_from_parts(a["Hr"], a["Hi"], dev),
                              "r": torch.from_numpy(a["r"]).to(dev)}
                fn = deg.build_family_apply(key, lmax)
                xd = torch.from_numpy(x).to(dev)
                out.append(fn(None, xd, torch.tensor(lengths, device=dev), params).cpu().numpy())
            got, cpu = out
            sos = design_lowpass_sos(ftype, spec.clamped_order, spec.highcut, 44100)
            for j, n in enumerate(lengths):
                ref = scipy_sff(sos, x[j, :n].astype(np.float64))
                scale = np.abs(ref).max()
                assert np.abs(got[j, :n] - cpu[j, :n]).max() <= 1e-5 * scale, (ftype, order)
                assert np.abs(got[j, :n] - ref).max() <= 1e-4 * scale, (ftype, order)
                assert not got[j, n:].any()


@pytest.mark.cuda
def test_mixed_family_sweep_on_card_matches_cpu(card, tmp_path, monkeypatch):
    """fft, IIR, subsampling and mp3 specs in one sweep, card vs CPU.  The
    mp3 codec is the real one where libmp3lame is present, else a
    deterministic quantize-and-delay stand-in."""
    from ssr_eval_tpu_torch.degrade import codec
    from ssr_eval_tpu_torch.io import mp3_lame
    from ssr_eval_tpu_torch.io.audio import read_wav

    if not mp3_lame.available():

        def stub(src_wav, kbps, backend, workdir):
            y, sr = read_wav(src_wav)
            out = os.path.join(workdir, "dec.wav")
            write_wav(out, np.concatenate([np.zeros(37, np.float32), np.round(y * 2048) / 2048]), sr)
            return out

        monkeypatch.setattr(codec, "detect_backend", lambda: "stub")
        monkeypatch.setattr(codec, "_encode_decode_mp3", stub)
    paths = []
    for i, dur in enumerate([0.5, 0.8, 1.1]):
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, speechlike(dur, 44100, seed=80 + i), 44100)
        paths.append(p)
    specs = expand_settings(
        setting_lowpass_filtering={"filter": ["butter", "cheby", "ellip", "bessel"], "cutoff_freq": [4000],
                                   "filter_order": [6]},
        setting_subsampling={"cutoff_freq": [4000]}, setting_mp3_compression={"low_kbps": [64]},
        setting_fft={"cutoff_freq": [8000]}, sr=44100,
    )
    noise = (1e-3 * np.random.default_rng(777).standard_normal(1 << 17)).astype(np.float32)
    out = []
    for dev in (card, torch.device("cpu")):
        eng = EvalEngine(specs, 44100, 44100, 44100, NoisyTestee(state_from_numpy(noise, dev)),
                         batch_size=2, device=dev)
        out.append(eng.evaluate_files(paths))
    got, cpu = out
    for p in paths:
        assert list(got[p]) == [s.key for s in specs]
        for s in specs:
            for k, tol in CARD_VS_CPU.items():
                a, b = got[p][s.key][k], cpu[p][s.key][k]
                assert np.isfinite(a) and abs(a - b) <= tol, (p, s.key, k, a, b)
