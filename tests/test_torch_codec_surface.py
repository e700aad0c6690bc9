"""The port's mp3 codec edge, correlation alignment and public DSP/metrics
surface (plain PyTorch on the CPU) against the JAX package on the same
numpy inputs.

Tolerances: the mp3 path bit-for-bit where both packages hand the codec
the same samples (identical shift, waveforms within 1e-6); float32 DSP
(lowpass, bandpass, FDomainHelper, postprocessing) within 1e-5 of the
signal's peak; AudioMetrics within PARITY of test_torch_harness.py in
float32 and 1e-9 in float64 (the same NumPy formulas).
"""

import importlib
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from scipy.signal import correlate

import jax.numpy as jnp

import ssr_eval_tpu
import ssr_eval_tpu_torch
from ssr_eval_tpu.degrade import codec as jcodec
from ssr_eval_tpu.dsp.correlate import align_by_correlation as j_align
from ssr_eval_tpu.dsp.correlate import cross_correlate_full as j_xcorr
from ssr_eval_tpu_torch.degrade import codec as tcodec
from ssr_eval_tpu_torch.dsp.correlate import align_by_correlation, cross_correlate_full
from ssr_eval_tpu_torch.io import mp3_lame
from ssr_eval_tpu_torch.io.audio import decode_audio, read_wav, write_wav
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from tests.test_torch_harness import NOISE, PARITY

# Both packages' `degrade` re-export the function `lowpass` over its module.
jlow = importlib.import_module("ssr_eval_tpu.degrade.lowpass")
tlow = importlib.import_module("ssr_eval_tpu_torch.degrade.lowpass")

METRICS = ("lsd", "log_sispec", "sispec", "ssim")
needs_lame = pytest.mark.skipif(not mp3_lame.available(), reason="libmp3lame not present")


def _sig(n, seed=0, sr=44100):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / sr
    return (
        0.4 * np.sin(2 * np.pi * 700 * t)
        + 0.3 * np.sin(2 * np.pi * 8000 * t + 1.0)
        + 0.02 * rng.standard_normal(n)
    ).astype(np.float32)


# ----------------------------------------------------------------------
# Correlation and the mp3 codec edge
# ----------------------------------------------------------------------


def test_cross_correlate_full_matches_scipy_and_jax():
    a, b = _sig(3001, seed=1), _sig(2500, seed=2)
    got = cross_correlate_full(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    ref = correlate(a.astype(np.float64), b.astype(np.float64), mode="full")
    want = np.asarray(j_xcorr(jnp.asarray(a), jnp.asarray(b)))
    scale = np.abs(ref).max()
    assert got.shape == ref.shape == want.shape
    assert np.abs(got - ref).max() < 1e-5 * scale
    assert np.abs(got - want).max() < 1e-5 * scale


@pytest.mark.parametrize("delay", [37, 0, -25])
def test_align_by_correlation_matches_jax(delay):
    """Identical shift for a delayed, an aligned and an advanced copy (the
    reference's argmax - len(x) formula, one sample off the true lag)."""
    x = _sig(12000, seed=3)
    y = np.roll(x, delay) + 0.01 * _sig(12000, seed=4)
    got = align_by_correlation(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(j_align(jnp.asarray(y), jnp.asarray(x)))
    np.testing.assert_array_equal(got, want)


def _stub_encode_decode(src_wav, kbps, backend, workdir):
    """Lossy stand-in for a codec round trip: quantize and delay by 37
    samples (tests/test_degrade.py's stub)."""
    y, sr = read_wav(src_wav)
    y = np.round(y * 2048) / 2048
    y = np.concatenate([np.zeros(37, np.float32), y]).astype(np.float32)
    out = os.path.join(workdir, "dec.wav")
    write_wav(out, y, sr)
    return out


def test_mp3_degrade_stub_codec_matches_jax(tmp_path, monkeypatch):
    x = _sig(20000, seed=21)
    for mod in (tcodec, jcodec):
        monkeypatch.setattr(mod, "detect_backend", lambda: "stub")
        monkeypatch.setattr(mod, "_encode_decode_mp3", _stub_encode_decode)
    cache = str(tmp_path / "utt_proc_mp3_64_44100.flac")
    got = tcodec.mp3_degrade("utt.flac", x, 44100, 64, cache_path=cache, device="cpu")
    want = jcodec.mp3_degrade("utt.flac", x, 44100, 64)
    np.testing.assert_array_equal(got, want)
    # out[n] == quantized x[n-1] in the interior: the reference's shift
    # formula leaves one sample of residual delay.
    assert np.abs(got[101:-100] - np.round(x[100:-101] * 2048) / 2048).max() < 2e-3
    y, sr = decode_audio(cache)
    assert sr == 44100
    np.testing.assert_allclose(y[:, 0] if y.ndim > 1 else y, got, atol=1e-4)


@needs_lame
@pytest.mark.parametrize("sr,kbps", [(44100, 32), (48000, 64)])
def test_mp3_degrade_real_lame_matches_jax(tmp_path, sr, kbps):
    x = _sig(30000, seed=11, sr=sr)
    assert tcodec.detect_backend() == "lame"
    got = tcodec.mp3_degrade("utt.flac", x, sr, kbps, cache_path=str(tmp_path / "c.flac"), device="cpu")
    want = jcodec.mp3_degrade("utt.flac", x, sr, kbps)
    assert got.shape == x.shape and float(np.sum(got - x)) != 0.0
    # the same codec output, so the same shift: the first nonzero sample
    # lands at the same index, and the waveforms agree
    assert np.argmax(got != 0) == np.argmax(want != 0)
    assert np.abs(got - want).max() <= 1e-6


@needs_lame
def test_lame_concurrent_round_trips_are_deterministic():
    """The module lock: concurrent encode+decode round trips equal serial
    ones (libmp3lame shares library-global tables)."""
    xs = [_sig(int(0.4 * 44100), seed=30 + i) for i in range(3)]

    def rt(x):
        return mp3_lame.decode_mp3(mp3_lame.encode_mp3(x, 44100, 32))[0]

    ref = [rt(x).tobytes() for x in xs]
    for _ in range(3):
        with ThreadPoolExecutor(max_workers=4) as ex:
            assert [o.tobytes() for o in ex.map(rt, xs)] == ref


@needs_lame
def test_lame_rejection_falls_back_or_raises(monkeypatch):
    """A rate LAME rejects raises CodecUnavailableError without a CLI codec,
    and is cached so a present CLI codec is used without retrying LAME."""
    x = (0.1 * np.sin(np.arange(13000) * 0.05)).astype(np.float32)
    monkeypatch.setattr(tcodec.shutil, "which", lambda name: None)
    with pytest.raises(tcodec.CodecUnavailableError, match="LAME failed"):
        tcodec.mp3_degrade("utt.flac", x, 13000, 32, device="cpu")
    assert (13000, 32) in tcodec._lame_rejections
    calls = []

    def fake(src_wav, kbps, backend, workdir):
        calls.append(backend)
        y, sr = read_wav(src_wav)
        out = os.path.join(workdir, "dec.wav")
        write_wav(out, np.round(y * 1024) / 1024, sr)
        return out

    def boom(*a, **k):
        raise AssertionError("LAME re-attempted a cached rejection")

    monkeypatch.setattr(tcodec.shutil, "which", lambda name: "/usr/bin/sox" if name == "sox" else None)
    monkeypatch.setattr(tcodec, "_encode_decode_mp3", fake)
    monkeypatch.setattr(mp3_lame, "encode_mp3", boom)
    assert tcodec.mp3_degrade("utt.flac", x, 13000, 32, device="cpu").shape == x.shape
    assert calls == ["sox"]


def test_no_codec_raises_codec_unavailable(monkeypatch):
    monkeypatch.setattr(tcodec, "detect_backend", lambda: None)
    with pytest.raises(tcodec.CodecUnavailableError, match="requires a host codec"):
        tcodec.mp3_degrade("utt.flac", _sig(5000), 44100, 32, device="cpu")


def test_flac_encode_matches_jax_bytes(tmp_path):
    """The mp3 cache's FLAC encoder (VERBATIM subframes, vectorized CRC-16
    and sample packing) writes the JAX package's bytes exactly."""
    from ssr_eval_tpu.io import flac_py as jflac
    from ssr_eval_tpu_torch.io import flac_py as tflac

    rng = np.random.default_rng(9)
    for n, ch, bps in [(20000, 1, 16), (4097, 2, 16), (3001, 1, 24), (777, 1, 12)]:
        x = np.clip(0.3 * rng.standard_normal((n, ch)), -1, 1)
        tflac.encode_flac(str(tmp_path / "t.flac"), x, 44100, bps=bps)
        jflac.encode_flac(str(tmp_path / "j.flac"), x, 44100, bps=bps)
        assert (tmp_path / "t.flac").read_bytes() == (tmp_path / "j.flac").read_bytes(), (n, ch, bps)
    for n in (0, 1, 63, 64, 65, 8193):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert tflac._crc16(data) == jflac._crc16(data), n


# ----------------------------------------------------------------------
# degrade/lowpass.py
# ----------------------------------------------------------------------


def _close(got, want, tol=1e-5):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("_type", ["butt", "cheby1", "ellip", "bessel", "subsampling", "stft_hard"])
def test_lowpass_matches_jax(_type):
    """Substring dispatch, order clamp (15 -> 10) and every branch."""
    x = _sig(9000, seed=5)
    got = tlow.lowpass(x, 4000, 44100, order=15, _type=_type, device="cpu")
    _close(got, jlow.lowpass(x, 4000, 44100, order=15, _type=_type))


def test_lowpass_validation():
    with pytest.raises(ValueError):
        tlow.lowpass(np.zeros((100, 1), np.float32), 4000, 44100, device="cpu")
    with pytest.raises(ValueError, match="Unexpected filter type"):
        tlow.lowpass(_sig(5000), 4000, 44100, _type="nonsense", device="cpu")
    with pytest.raises(ValueError, match="not supported"):
        tlow.lowpass_filter(_sig(5000), 4000, 44100, 4, "cheby", device="cpu")
    assert tlow.limit(15, 10, 2) == 10 and tlow.limit(1, 10, 2) == 2 and tlow.limit(5.0, 10, 2) == 5


def test_bandpass_and_exact_filters_match_jax():
    x = _sig(9000, seed=6)
    _close(tlow.bandpass(x, 1000, 6000, 44100, order=4, _type="butter", device="cpu"),
           jlow.bandpass(x, 1000, 6000, 44100, order=4, _type="butter"))
    _close(tlow.lowpass_filter(x, 4000, 44100, 12, "cheby2", device="cpu"),
           jlow.lowpass_filter(x, 4000, 44100, 12, "cheby2"))
    _close(tlow.bandpass_filter(x, 1000, 6000, 44100, 4, "ellip", device="cpu"),
           jlow.bandpass_filter(x, 1000, 6000, 44100, 4, "ellip"))


def test_stft_hard_subsampling_and_align_length_match_jax():
    x = _sig(8000, seed=7)
    _close(tlow.stft_hard_lowpass_v0(x, 6000 / 22050, device="cpu"), jlow.stft_hard_lowpass_v0(x, 6000 / 22050))
    np.testing.assert_array_equal(tlow.subsampling(x, 0.25), jlow.subsampling(x, 0.25))
    for y in (x[:100], x[:8000], np.concatenate([x, x[:5]])):
        np.testing.assert_array_equal(tlow.align_length(x, y), jlow.align_length(x, y))


def test_lowpass_test1_writes_wavs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    tlow.test1(device="cpu")
    for name in ("original", "butter", "cheby1", "stft_hard", "subsampling"):
        y, sr = decode_audio(str(tmp_path / f"{name}.wav"))
        assert sr == 44100 and y.shape == (88200,)


# ----------------------------------------------------------------------
# FDomainHelper, AudioMetrics, BasicTestee helpers
# ----------------------------------------------------------------------


def test_fdomain_helper_matches_jax():
    from ssr_eval_tpu.dsp.fdomain import FDomainHelper as JF
    from ssr_eval_tpu_torch.dsp.fdomain import FDomainHelper

    x = np.stack([_sig(6000, seed=8), _sig(6000, seed=9)])  # [B, samples]
    x3 = x[:, None, :].repeat(2, axis=1)  # [B, C, samples]
    for kw in ({}, {"subband": 2}):
        t, j = FDomainHelper(device="cpu", **kw), JF(**kw)
        _close(t.spectrogram(x), j.spectrogram(x))
        # cos/sin = real/|X| are ill-conditioned where |X| is tiny: compare
        # |X| and |X| * (cos, sin)
        for fn, arg in (("spectrogram_phase", x), ("wav_to_spectrogram_phase", x3)):
            (tm, tc, ts), (jm, jc, js) = getattr(t, fn)(arg), getattr(j, fn)(arg)
            _close(tm, jm)
            _close(tm * tc, jm * jc)
            _close(tm * ts, jm * js)
        _close(t.wav_to_spectrogram(x3), j.wav_to_spectrogram(x3))
        cs = t.complex_spectrogram(x)
        _close(cs, j.complex_spectrogram(x))
        _close(t.reverse_complex_spectrogram(cs, length=6000), j.reverse_complex_spectrogram(cs, length=6000))
        wcs = t.wav_to_complex_spectrogram(x3)
        _close(wcs, j.wav_to_complex_spectrogram(x3))
        _close(t.complex_spectrogram_to_wav(wcs, length=6000), j.complex_spectrogram_to_wav(wcs, length=6000))
        sps, cos, sin = t.wav_to_spectrogram_phase(x3)
        _close(t.spectrogram_phase_to_wav(sps, cos, sin, 6000), j.spectrogram_phase_to_wav(sps, cos, sin, 6000))
        _close(t.spectrogram_to_wav(x3, sps * 0.5, length=6000), j.spectrogram_to_wav(x3, sps * 0.5, length=6000))
    # the round trip returns the signal
    f = FDomainHelper(device="cpu")
    np.testing.assert_allclose(f.reverse_complex_spectrogram(f.complex_spectrogram(x), length=6000), x, atol=1e-5)


@pytest.mark.parametrize("precision", ["float32", "float64"])
def test_audio_metrics_matches_jax(precision, tmp_path):
    from ssr_eval_tpu.metrics.audio_metrics import AudioMetrics as JA
    from ssr_eval_tpu_torch.metrics import AudioMetrics

    # a speech-like target and the NoisyTestee's broadband floor on the
    # estimate (no spectrum at a float32 floor), 50 samples short
    tgt = speechlike(0.5, 44100, seed=3)
    est = (tgt[:22000] + NOISE[:22000]).astype(np.float32)
    t, j = AudioMetrics(44100, precision, device="cpu"), JA(44100, precision)
    tol = PARITY if precision == "float32" else dict.fromkeys(METRICS, 1e-9)
    got, want = t.evaluation(est, tgt), j.evaluation(est, tgt)
    for k in METRICS:
        assert abs(got[k] - want[k]) <= tol[k], (k, got[k], want[k])
    pe, pt = str(tmp_path / "e.wav"), str(tmp_path / "t.wav")
    write_wav(pe, est, 44100)
    write_wav(pt, tgt, 44100)
    got, want = t.evaluation(pe, pt), j.evaluation(pe, pt)
    for k in METRICS:
        assert abs(got[k] - want[k]) <= tol[k], (k, got[k], want[k])
    with pytest.raises(ValueError, match="both be numpy array or strings"):
        t.evaluation(pe, tgt)
    with pytest.raises(AssertionError, match="Shape mismatch"):
        t.evaluation(est[:20000], tgt)
    with pytest.raises(AssertionError, match="shape should be"):
        t.evaluation(est[None], tgt[None])
    assert (t.hop_length, t.n_fft) == (j.hop_length, j.n_fft) == (441, 2048)


def test_audio_metrics_spectrogram_surface_matches_jax():
    from ssr_eval_tpu.metrics.audio_metrics import AudioMetrics as JA
    from ssr_eval_tpu_torch.metrics import AudioMetrics

    t, j = AudioMetrics(48000, device="cpu"), JA(48000)
    a, b = _sig(14000, seed=12, sr=48000), _sig(14000, seed=13, sr=48000)
    sa, sb = t.wav_to_spectrogram(a), t.wav_to_spectrogram(b)
    _close(sa, j.wav_to_spectrogram(a))
    assert sa.shape[:2] == (1, 1) and sa.shape[3] == 2229 // 2 + 1
    est, tgt = np.concatenate([sa, sb]), np.concatenate([sb, sa])
    _close(t.lsd(est, tgt), j.lsd(est, tgt))
    assert abs(t.sispec(est, tgt) - j.sispec(est, tgt)) < 1e-4
    _close(t.ssim(torch.from_numpy(est), tgt), j.ssim(est, tgt))
    x, y = np.zeros((1, 1, 20, 3)), np.zeros((1, 1, 16, 3))
    for got, want in zip(t.center_crop(x, y), j.center_crop(x, y)):
        assert got.shape == want.shape == (1, 1, 16, 3)
    with pytest.raises(ValueError, match="precision"):
        AudioMetrics(44100, "float16", device="cpu")


def test_basic_testee_postprocessing_matches_jax():
    from ssr_eval_tpu_torch.harness.testee import BasicTestee

    x = _sig(15000, seed=14)
    out = (0.5 * _sig(15000, seed=15) + 0.5 * x).astype(np.float32)
    t, j = BasicTestee(), ssr_eval_tpu.BasicTestee()
    t.device = "cpu"
    assert t._get_cutoff_index(x) == j._get_cutoff_index(x)
    assert t._find_cutoff(np.arange(10.0)) == j._find_cutoff(np.arange(10.0)) == 8
    _close(t.postprocessing(x, out), j.postprocessing(x, out))
    _close(t.postprocessing(x, out[:14000]), j.postprocessing(x, out[:14000]))


def test_helper_per_family_methods_match_jax(tmp_path):
    """The helper's single-utterance sweep methods and length helpers."""
    from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk

    root = ensure_synthetic_vctk(str(tmp_path / "vctk"), files_per_speaker=1)
    kw = dict(
        input_sr=44100, output_sr=44100, test_data_root=root, auto_download=False,
        # 22050 doubles to the sample rate: the key carries 44099
        setting_lowpass_filtering={"filter": ["butter"], "cutoff_freq": [8000, 22050], "filter_order": [4]},
        setting_subsampling={"cutoff_freq": [8000]}, setting_fft={"cutoff_freq": [8000]},
    )
    t = ssr_eval_tpu_torch.SSR_Eval_Helper(ssr_eval_tpu_torch.BasicTestee(), device="cpu", **kw)
    j = ssr_eval_tpu.SSR_Eval_Helper(ssr_eval_tpu.BasicTestee(), **kw)
    x = _sig(9000, seed=16)
    for name in ("lowpass_butterworth", "lowpass_chebyshev", "lowpass_ellip", "lowpass_bessel",
                 "lowpass_stft_hard", "lowpass_subsampling"):
        got, want = getattr(t, name)("f.wav", x, 44100), getattr(j, name)("f.wav", x, 44100)
        assert list(got) == list(want), name
        for k in want:
            _close(got[k], want[k])
    assert "proc_bw_44099_4_44100" in t.lowpass_butterworth("f.wav", x, 44100)
    for s in (3, -3):
        np.testing.assert_array_equal(t.shift(x[:20], s), j.shift(x[:20], s))
    for a, b in ((x[:10], x[:12]), (x[:12], x[:10])):
        for g, w in zip(t.pad(a, b), j.pad(a, b)):
            np.testing.assert_array_equal(g, w)
        for g, w in zip(t.unify_length(a, b), j.unify_length(a, b)):
            np.testing.assert_array_equal(g, w)
    assert t.cache_file_name("proc_mp3_32_44100", "/d/u.flac") == j.cache_file_name("proc_mp3_32_44100", "/d/u.flac")
    assert t.audio_metrics.rate == 44100 and t.unexpected_symbol_test_folder == j.unexpected_symbol_test_folder


@needs_lame
def test_helper_mp3_encoding_matches_jax(tmp_path):
    kw = dict(input_sr=44100, output_sr=44100, test_data_root=str(tmp_path), auto_download=False,
              setting_mp3_compression={"low_kbps": [32, 64]})
    t = ssr_eval_tpu_torch.SSR_Eval_Helper(ssr_eval_tpu_torch.BasicTestee(), device="cpu", **kw)
    j = ssr_eval_tpu.SSR_Eval_Helper(ssr_eval_tpu.BasicTestee(), **kw)
    x = _sig(12000, seed=17)
    f = str(tmp_path / "u.flac")
    got = t.mp3_encoding(f, x, 44100)
    assert os.path.exists(str(tmp_path / "u_proc_mp3_64_44100.flac"))
    want = j.mp3_encoding(f, x, 44100)
    assert list(got) == list(want) == ["proc_mp3_32_44100", "proc_mp3_64_44100"]
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= 1e-6


# ----------------------------------------------------------------------
# Symbol parity of the public surface
# ----------------------------------------------------------------------


def _public(mod):
    """{name} and {Class.method} of a module's __all__."""
    out = set()
    for name in mod.__all__:
        out.add(name)
        obj = getattr(mod, name)
        if isinstance(obj, type):
            out |= {f"{name}.{m}" for m in vars(obj) if not m.startswith("_")}
    return out


# XLA tracing and loop-structure hints of the JAX engine, with no meaning
# for the eager PyTorch engine.
EXCLUDE = {"BatchedTestee.jittable", "BatchedTestee.infer_cost_hint"}


@pytest.mark.parametrize("mod", ["lowpass", "eval", "dsp", "metrics"])
def test_public_surface_symbol_parity(mod):
    want = _public(importlib.import_module(f"ssr_eval_tpu.{mod}")) - EXCLUDE
    ours = importlib.import_module(f"ssr_eval_tpu_torch.{mod}")
    missing = []
    for sym in sorted(want):
        owner, _, attr = sym.partition(".")
        obj = getattr(ours, owner, None)
        if obj is None or (attr and not hasattr(obj, attr)):
            missing.append(sym)
    assert not missing, f"ssr_eval_tpu_torch.{mod} lacks {missing}"
    assert set(ours.__all__) == {s for s in want if "." not in s}
