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
(chip_smoke.py's limits); the |STFT| eps floor on the card within 1e-5 of
max of the CPU's with silent frames at exactly sqrt(eps); a small-width
NVSR testee's waveform on the card within 1e-4 of max|CPU| (cuDNN's fp32
convolutions against the CPU's, TF32 off); the |STFT| backward kernel
within 1e-5 of max|grad| of its plain version (torch autograd) and of a
float64 autograd (both float32 FFTs round at ~1e-6 of max), a row's
gradient bit-identical alone and inside a batch, whatever the frames per
segment; the engine's CUDA graphs bit-identical to its eager chain (the
same kernels on the same shapes).
"""

import os

import numpy as np
import pytest
import torch
from scipy.signal import sosfiltfilt as scipy_sff

from ssr_eval_tpu_torch.degrade import apply as deg

from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.dsp import stft_kernel
from ssr_eval_tpu_torch.dsp.spectral import window_tensor
from ssr_eval_tpu_torch.dsp.stft_kernel import (
    stft_magnitude_backward_kernel,
    stft_magnitude_backward_plain,
    stft_magnitude_kernel,
    stft_magnitude_plain,
)
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
        # the NVSR post-processing cutoff detection (librosa's 2048/512)
        (2048, 512, 4),
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


def _nvsr_buffers():
    from ssr_eval_tpu_torch.harness.fixtures import speechlike as sl

    a = sl(0.3, 44100, seed=3)
    a[4000:9000] = 0.0
    b = 0.5 * sl(0.2, 44100, seed=4)
    x = np.zeros((2, 16384), np.float32)
    x[0, : len(a)] = a
    x[1, : len(b)] = b
    return torch.from_numpy(x), torch.tensor([len(a), len(b)])


@pytest.mark.cuda
def test_stft_eps_on_card_matches_cpu(card):
    from ssr_eval_tpu_torch.dsp.spectral import stft_magnitude
    from ssr_eval_tpu_torch.models.nvsr import NVSR_STFT

    x, n = _nvsr_buffers()
    mf = NVSR_STFT.max_frames(x.shape[1])
    before = stft_magnitude_kernel.launches
    got = stft_magnitude(x.to(card), n.to(card), NVSR_STFT, mf, eps=1e-8).cpu()
    assert stft_magnitude_kernel.launches == before + 1
    want = stft_magnitude(x, n, NVSR_STFT, mf, eps=1e-8)
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert float(got.min()) == pytest.approx(1e-4, rel=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("cls", ["NVSRTestee", "NVSRPostProcTestee"])
def test_small_nvsr_on_card_matches_cpu(card, cls):
    from ssr_eval_tpu_torch.models import nvsr, testees
    from ssr_eval_tpu_torch.models.unet import UNetRes
    from ssr_eval_tpu_torch.models.vocoder import TFGANConfig

    def small_testee(device):
        # the UNet generator at widths (8, 16), 2 blocks per group, and the
        # trained_small-width vocoder, installed into a default testee
        base = nvsr.NVSR("dnn", vocoder_cfg=TFGANConfig(channels=96, res_dilations=(1, 3)))
        with torch.device("meta"):
            base.generator = nvsr.Generator("unet")
        base.generator.analysis_module = UNetRes(channels=1, widths=(8, 16), blocks_per_group=2)
        t = getattr(testees, cls)(model_name="dnn", device=device)
        t._set_base(nvsr.init_weights(base, seed=7))
        return t

    x, n = _nvsr_buffers()
    t_card = small_testee("cuda")
    before = stft_magnitude_kernel.launches
    y, ny = t_card.infer_batch(x.to(card), n.to(card), t_card.device_state())
    torch.cuda.synchronize()
    assert stft_magnitude_kernel.launches == before + (1 if cls == "NVSRTestee" else 2)
    want, _ = small_testee("cpu").infer_batch(x, n)
    assert torch.equal(ny.cpu(), n)
    assert ((y.cpu() - want).abs().max() / want.abs().max()).item() <= 1e-4


@pytest.mark.cuda
def test_nvsr_infer_batch_leaves_no_graph_on_card(card):
    from ssr_eval_tpu_torch.models import testees

    t = testees.NVSRTestee(model_name="dnn", device="cuda")
    x, n = _nvsr_buffers()
    torch.cuda.reset_peak_memory_stats()
    y, _ = t.infer_batch(x.to(card), n.to(card))
    assert y.grad_fn is None and not y.requires_grad and torch.is_inference(y)
    assert all(p.requires_grad for p in t.model.parameters())


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n_fft,hop,rows,mf",
    [
        (2048, 441, 4, 36), (2048, 441, 3, 37), (512, 128, 4, 37), (4096, 1024, 2, 9),
        (2, 1, 3, 5), (32, 7, 2, 7), (256, 300, 2, 5),
        # Bluestein: the 48 kHz and 16 kHz metric STFTs, N = 1, a small N and
        # the 8192-point transforms (2732 and 4095)
        (2229, 480, 4, 36), (743, 160, 3, 37), (1, 1, 3, 5), (17, 5, 2, 9), (2732, 500, 2, 5),
        (4095, 1000, 2, 5),
        # hops far below N/4: halos of 31 and 44 frames
        (4096, 128, 2, 40), (2229, 50, 2, 60),
    ],
)
def test_cuda_backward_kernel_matches_plain_and_float64(card, n_fft, hop, rows, mf):
    g = torch.Generator().manual_seed(n_fft + mf)
    ext = (0.1 * torch.randn(rows, (mf - 1) * hop + n_fft + 13, generator=g)).to(card)
    gm = torch.randn(rows, mf, n_fft // 2 + 1, generator=g).to(card)
    win = window_tensor(n_fft, n_fft, card) if n_fft > 1 else torch.ones(1, device=card)  # hann(1) = 0
    before = stft_magnitude_backward_kernel.launches
    got = stft_magnitude_backward_kernel(ext, gm, n_fft, hop, mf, win)
    torch.cuda.synchronize()
    assert stft_magnitude_backward_kernel.launches == before + 1
    want = stft_magnitude_backward_plain(ext, gm, n_fft, hop, mf, win)
    ref = stft_magnitude_backward_plain(ext.double(), gm.double(), n_fft, hop, mf, win.double())
    assert got.shape == ext.shape
    assert ((got - want).abs().max() / want.abs().max()).item() <= 1e-5
    assert ((got.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
def test_cuda_ext_requiring_grad_gets_the_backward_kernel(card):
    """The fault this route repairs: a CUDA ext that requires a gradient
    once left the kernel with no grad_fn.  Now the graph holds
    StftMagnitudeFn, and backward() launches the backward kernel once and
    matches the CPU's autograd through the eps floor and _extend."""
    from ssr_eval_tpu_torch.dsp.spectral import stft_magnitude
    from ssr_eval_tpu_torch.models.nvsr import NVSR_STFT

    x, n = _nvsr_buffers()
    mf = NVSR_STFT.max_frames(x.shape[1])
    gm = torch.randn(2, mf, NVSR_STFT.n_bins, generator=torch.Generator().manual_seed(5))
    xc = x.to(card).requires_grad_(True)
    mag = stft_magnitude(xc, n.to(card), NVSR_STFT, mf, eps=1e-8)
    assert mag.grad_fn is not None
    before = stft_magnitude_backward_kernel.launches
    mag.backward(gm.to(card))
    torch.cuda.synchronize()
    assert stft_magnitude_backward_kernel.launches == before + 1
    xh = x.clone().requires_grad_(True)
    stft_magnitude(xh, n, NVSR_STFT, mf, eps=1e-8).backward(gm)
    # the speech rows hold bins just above the eps floor, whose phase
    # float32 resolves only to ~1e-2: 1e-4 of max (tests/test_torch_train_vocoder.py)
    assert ((xc.grad.cpu() - xh.grad).abs().max() / xh.grad.abs().max()).item() <= 1e-4
    with torch.no_grad():
        assert stft_magnitude(xc, n.to(card), NVSR_STFT, mf).grad_fn is None


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(2229, 480), (743, 160)])
def test_cuda_bluestein_backward_through_function(card, n_fft, hop):
    """A Bluestein n_fft's gradient through StftMagnitudeFn: one backward
    launch per backward(), within 1e-4 of max of the plain version and 1e-5
    of a float64 autograd."""
    mf = 21
    g = torch.Generator().manual_seed(n_fft)
    ext = (0.1 * torch.randn(2, (mf - 1) * hop + n_fft + 5, generator=g)).to(card)
    gm = torch.randn(2, mf, n_fft // 2 + 1, generator=g).to(card)
    win = window_tensor(n_fft, n_fft, card)
    e = ext.clone().requires_grad_(True)
    mag = stft_magnitude_kernel(e, n_fft, hop, mf, win)
    assert mag.grad_fn is not None and "StftMagnitudeFn" in type(mag.grad_fn).__name__
    before = stft_magnitude_backward_kernel.launches
    mag.backward(gm)
    torch.cuda.synchronize()
    assert stft_magnitude_backward_kernel.launches == before + 1
    want = stft_magnitude_backward_plain(ext, gm, n_fft, hop, mf, win)
    ref = stft_magnitude_backward_plain(ext.double(), gm.double(), n_fft, hop, mf, win.double())
    assert ((e.grad - want).abs().max() / want.abs().max()).item() <= 1e-4
    assert ((e.grad.double() - ref).abs().max() / ref.abs().max()).item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n_fft,hop", [(2048, 441), (2229, 480)])
def test_cuda_backward_row_alone_equals_in_batch(card, n_fft, hop):
    """Each output sample is one fixed-order sum over its frames, so row 0's
    gradient is bit-identical alone, inside a batch of 16 and at any number
    of frames per segment."""
    mf = 60
    g = torch.Generator().manual_seed(7)
    ext = (0.1 * torch.randn(16, (mf - 1) * hop + n_fft, generator=g)).to(card)
    gm = torch.randn(16, mf, n_fft // 2 + 1, generator=g).to(card)
    win = window_tensor(n_fft, n_fft, card)
    one = stft_magnitude_backward_kernel(ext[:1].contiguous(), gm[:1].contiguous(), n_fft, hop, mf, win)
    for seg in (0, 1, 3, 16, mf):  # 0: the kernel's own choice
        batch = stft_kernel._backward(ext, gm, n_fft, hop, mf, win, seg)
        assert torch.equal(batch[:1], one), seg


# The engine's CUDA graphs.  Files at 48 kHz: three share one bucket (with
# batch 2, a batch of two rows and a remainder of one: two keys), two more
# buckets of one row each.
GRAPH_DURS = (0.5, 0.51, 0.505, 0.8, 1.1)
GRAPH_SETTINGS = {
    "fft": {"setting_fft": {"cutoff_freq": [4000, 8000, 16000]}},
    "mixed": {"setting_fft": {"cutoff_freq": [8000]}, "setting_subsampling": {"cutoff_freq": [4000]},
              "setting_lowpass_filtering": {"filter": ["butter", "cheby", "ellip", "bessel"],
                                            "cutoff_freq": [4000], "filter_order": [6]}},
}


def _graph_files(tmp_path, durs, seed=200):
    paths = []
    for i, dur in enumerate(durs):
        p = str(tmp_path / f"g{i}.wav")
        write_wav(p, speechlike(dur, 48000, seed=seed + i), 48000)
        paths.append(p)
    return paths


def _graph_engine(card, family="fft", eval_sr=44100, graphs=True):
    noise = (1e-3 * np.random.default_rng(777).standard_normal(1 << 17)).astype(np.float32)
    specs = expand_settings(sr=44100, **GRAPH_SETTINGS[family])
    eng = EvalEngine(specs, 44100, 44100, eval_sr, NoisyTestee(state_from_numpy(noise, card)), batch_size=2,
                     device=card)
    eng._use_graphs = graphs
    return eng


def _job(eng, paths):
    """-> (results, the job's counter deltas, its |STFT| launches)."""
    before, launches = dict(eng.stats.counters), stft_magnitude_kernel.launches
    out = eng.evaluate_files(paths)
    torch.cuda.synchronize()
    counters = {k: eng.stats.counters.get(k, 0) - before.get(k, 0)
                for k in ("dispatch_graphed", "dispatch_eager", "graph_captures")}
    return out, counters, stft_magnitude_kernel.launches - launches


@pytest.mark.cuda
@pytest.mark.parametrize("family,eval_sr", [("fft", 44100), ("fft", 48000), ("mixed", 44100)])
def test_graphed_sweep_is_bit_identical_to_eager(card, tmp_path, family, eval_sr):
    """A first job captures two graphs a batch key (rows, bucket: four keys,
    one a batch); a second captures none and replays every batch.  Both score every file bit for bit as the
    eager chain does, and count the eager chain's |STFT| launches."""
    paths = _graph_files(tmp_path, GRAPH_DURS)
    want, eager, eager_launches = _job(_graph_engine(card, family, eval_sr, graphs=False), paths)
    batches = eager["dispatch_eager"]
    assert batches == 4 and eager["dispatch_graphed"] == eager["graph_captures"] == 0
    eng = _graph_engine(card, family, eval_sr)
    first, c1, l1 = _job(eng, paths)
    second, c2, l2 = _job(eng, paths)
    assert c1 == {"dispatch_graphed": 0, "dispatch_eager": 4, "graph_captures": 8}
    assert c2 == {"dispatch_graphed": batches, "dispatch_eager": 0, "graph_captures": 0}
    assert l1 == l2 == eager_launches
    assert first == want and second == want


@pytest.mark.cuda
def test_graphed_pending_batches_of_one_key_keep_their_data(card, tmp_path):
    """Eight files of one bucket, batch 2: four batches of one key, up to
    MAX_PENDING + 1 = 3 of them queued at once over the same static
    buffers, each with its own data."""
    paths = _graph_files(tmp_path, [0.49 + 0.001 * i for i in range(8)], seed=300)
    want, _, _ = _job(_graph_engine(card, graphs=False), paths)
    assert len({v["proc_fft_4000_44100"]["lsd"] for v in want.values()}) == 8
    eng = _graph_engine(card)
    _job(eng, paths)
    got, counters, _ = _job(eng, paths)
    assert counters["dispatch_graphed"] == 4 and got == want


@pytest.mark.cuda
def test_graph_replays_survive_evicted_constants(card, tmp_path):
    """The graphs hold the device constants their captures read: emptied
    caches, a freed allocator cache and fresh NaN garbage leave the replays
    bit-identical."""
    import gc

    from ssr_eval_tpu_torch.dsp import spectral

    paths = _graph_files(tmp_path, GRAPH_DURS)
    eng = _graph_engine(card, "mixed")
    want, _, _ = _job(eng, paths)
    for cache in (spectral.window_tensor, spectral._wss_tensors, stft_kernel._tables, deg.spec_params,
                  deg._resample_weights):
        cache.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()
    junk = [torch.full((1 << k,), float("nan"), device=card) for k in range(8, 25) for _ in range(4)]
    got, counters, _ = _job(eng, paths)
    del junk
    assert counters == {"dispatch_graphed": 4, "dispatch_eager": 0, "graph_captures": 0}
    assert got == want


@pytest.mark.cuda
def test_profiler_sees_the_kernel_in_replayed_batches(card, tmp_path):
    paths = _graph_files(tmp_path, GRAPH_DURS)
    eng = _graph_engine(card)
    _job(eng, paths)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, counters, launches = _job(eng, paths)
    assert counters["dispatch_graphed"] == 4 and counters["graph_captures"] == 0
    names = [e.name for e in prof.events() if "stft_fft_kernel" in e.name]
    assert len(names) >= launches == 4 * (1 + 3), (len(names), launches)
