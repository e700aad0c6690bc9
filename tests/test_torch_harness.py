"""The port's harness (plain PyTorch on the CPU) vs the JAX package's:
sweep keys, FLAC decode, per-pair metrics of a well-conditioned fft
sweep, the results-JSON schema, batch-composition invariance and the
README smoke run's golden values.

Parity tolerances per (file, spec) pair, for the broadband NoisyTestee
(its spectra sit far above any float32 rounding floor, so the comparison
is of algorithms, not of floors — PARITY.md deviation 4): see PARITY below.
"""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ssr_eval_tpu
import ssr_eval_tpu_torch
from ssr_eval_tpu.degrade.plan import expand_settings as j_expand
from ssr_eval_tpu.harness.fixtures import ensure_synthetic_vctk as j_fixture
from ssr_eval_tpu.io.audio import decode_audio as j_decode, decode_audio_i16 as j_decode_i16
from ssr_eval_tpu_torch.degrade.plan import expand_settings as t_expand
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk, speechlike
from ssr_eval_tpu_torch.harness.testee import BatchedTestee, state_from_numpy
from ssr_eval_tpu_torch.io.audio import decode_audio, decode_audio_i16, write_wav
from tests.test_golden_synthetic import GOLDEN_AVERAGED, GOLDEN_P360, TOL

METRICS = ("lsd", "log_sispec", "sispec", "ssim")
# |port - JAX| per (file, spec) pair, about 5-10x the measured maxima
# (LSD 1.0e-5, log-SiSpec 9.3e-5, SiSpec 1.1e-5 dB, SSIM 3.6e-7; PERF.md).
PARITY = {"lsd": 1e-4, "log_sispec": 5e-4, "sispec": 1e-4, "ssim": 5e-6}
NOISE = (1e-3 * np.random.default_rng(777).standard_normal(1 << 17)).astype(np.float32)


class JaxNoisyTestee(ssr_eval_tpu.BatchedTestee):
    """Adds a fixed broadband floor (device state) to its input."""

    def device_state(self):
        return jnp.asarray(NOISE)

    def infer_batch(self, x, lengths, state=None):
        idx = jnp.arange(x.shape[1]) % state.shape[0]
        mask = (jnp.arange(x.shape[1])[None, :] < lengths[:, None]).astype(jnp.float32)
        return x.astype(jnp.float32) + state[idx][None, :] * mask, lengths


class NoisyTestee(BatchedTestee):
    """The same testee on torch tensors; its noise is handed across."""

    def __init__(self, state):
        self.state = state

    def device_state(self):
        return self.state

    def infer_batch(self, x, lengths, state=None):
        ar = torch.arange(x.shape[1], device=x.device)
        mask = (ar[None, :] < lengths[:, None]).to(torch.float32)
        return x.to(torch.float32) + state[ar % state.shape[0]][None, :] * mask, lengths


SETTINGS = [
    dict(setting_lowpass_filtering={"filter": ["butter", "cheby", "ellip", "bessel"],
                                    "cutoff_freq": [4000, 44100], "filter_order": [1, 8, 12]}),
    dict(setting_subsampling={"cutoff_freq": [2000, 44100]}),
    dict(setting_fft={"cutoff_freq": [2000, 8000, 44100]}),
    dict(setting_mp3_compression={"low_kbps": [32, 64]}),
]


@pytest.mark.parametrize("i", range(len(SETTINGS)))
def test_expand_settings_matches_jax(i):
    for sr in (44100, 16000):
        got = t_expand(sr=sr, **SETTINGS[i])
        want = j_expand(sr=sr, **SETTINGS[i])
        assert [tuple(s) for s in got] == [tuple(s) for s in want]
        assert [s.clamped_order for s in got] == [s.clamped_order for s in want]


@pytest.fixture(scope="module")
def vctk(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_vctk") / "vctk_test"
    return j_fixture(str(root), files_per_speaker=2)


def _files(root):
    return sorted(
        os.path.join(root, d, f)
        for d in os.listdir(root)
        for f in os.listdir(os.path.join(root, d))
        if f.endswith(".flac") and "proc" not in f
    )


def test_flac_decode_bit_identical(vctk):
    for p in _files(vctk):
        x, sr = decode_audio_i16(p)
        jx, jsr = j_decode_i16(p)
        assert sr == jsr and x.dtype == jx.dtype == np.int16
        np.testing.assert_array_equal(x, jx)
        f, _ = decode_audio(p)
        np.testing.assert_array_equal(f, j_decode(p)[0])


@pytest.fixture(scope="module")
def sweep(vctk, tmp_path_factory):
    """The same noisy fft sweep through both helpers (48 kHz evaluation:
    the 2229-point metric STFT and 44.1 -> 48 kHz resampling)."""
    kw = dict(
        input_sr=44100, output_sr=44100, evaluation_sr=48000, test_name="port_parity",
        test_data_root=vctk, setting_fft={"cutoff_freq": [2000, 8000]},
        auto_download=False, batch_size=4,
    )
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("port_sweep"))
    try:
        jt = JaxNoisyTestee()
        want = ssr_eval_tpu.SSR_Eval_Helper(jt, **kw).evaluate(verbose=False)
        state = state_from_numpy(np.asarray(jt.device_state()), "cpu")
        helper = ssr_eval_tpu_torch.SSR_Eval_Helper(NoisyTestee(state), device="cpu", **kw)
        got = helper.evaluate(verbose=False)
        written = sorted(os.listdir("results"))
    finally:
        os.chdir(cwd)
    return want, got, helper, written


def test_noisy_fft_sweep_matches_jax(sweep):
    want, got, _, _ = sweep
    n = 0
    worst = dict.fromkeys(METRICS, 0.0)
    for spk, files in want.items():
        if spk in ("each_speaker", "averaged"):
            continue
        for fname, specs in files.items():
            for key, m in specs.items():
                for k in METRICS:
                    d = abs(got[spk][fname][key][k] - m[k])
                    worst[k] = max(worst[k], d)
                    assert d <= PARITY[k], (spk, fname, key, k, got[spk][fname][key][k], m[k])
                n += 1
    assert n == 16 * 2
    print("max |port - JAX| per pair:", worst)  # shown with pytest -s


def test_results_schema_matches_jax(sweep):
    want, got, _, written = sweep

    def shape(d):
        return {k: shape(v) for k, v in d.items()} if isinstance(d, dict) else type(d).__name__

    assert shape(got) == shape(want)
    assert list(got["averaged"]) == ["proc_fft_4000_44100", "proc_fft_16000_44100"]
    # one timestamped JSON per helper run, plus each run's journal
    assert sum(f.endswith("-port_parity.json") for f in written) == 2
    assert "port_parity.partial.jsonl" in written


def test_evaluate_single_matches_sweep(sweep):
    _, got, helper, _ = sweep
    p = os.path.join(helper.test_data_root, "p361", sorted(got["p361"])[0])
    one = helper.evaluate_single(p)
    for key, m in got["p361"][os.path.basename(p)].items():
        for k in METRICS:
            assert abs(one[key][k] - m[k]) < 1e-5, (key, k)


def test_batch_composition_invariance(tmp_path):
    """Same file evaluated alone vs inside a mixed batch: identical."""
    paths = []
    for i, dur in enumerate([0.4, 0.7, 0.9]):
        x = speechlike(dur, 44100, seed=40 + i)
        p = str(tmp_path / f"b{i}.wav")
        write_wav(p, x, 44100)
        paths.append(p)
    specs = t_expand(setting_fft={"cutoff_freq": [8000]}, sr=44100)
    eng_all = EvalEngine(specs, 44100, 44100, 44100, BatchedTestee(), batch_size=3, device="cpu")
    eng_one = EvalEngine(specs, 44100, 44100, 44100, BatchedTestee(), batch_size=1, device="cpu")
    r_all = eng_all.evaluate_files(paths)
    worst = 0.0
    for p in paths:
        r_one = eng_one.evaluate_files([p])
        for m in METRICS:
            a = r_all[p]["proc_fft_8000_44100"][m]
            b = r_one[p]["proc_fft_8000_44100"][m]
            worst = max(worst, abs(a - b))
            assert abs(a - b) < 1e-5, (p, m, a, b)
    print("max |alone - in batch of 3|:", worst)  # shown with pytest -s


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_golden") / "vctk_test"
    ensure_synthetic_vctk(str(root), files_per_speaker=2)
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("port_golden_run"))
    try:
        return ssr_eval_tpu_torch.test(
            test_data_root=str(root), auto_download=False, batch_size=4, device="cpu"
        )
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("block", ["averaged", "p360"])
def test_smoke_matches_golden(smoke, block):
    """The README smoke run (identity testee, 48 kHz evaluation) against the
    JAX package's golden pins.  All four metrics land inside the golden
    TOL, including the floor-dominated LSD and log-SiSpec."""
    if block == "averaged":
        got, golden = smoke["averaged"]["proc_fft_24000_44100"], GOLDEN_AVERAGED
    else:
        got, golden = smoke["each_speaker"]["p360"]["proc_fft_24000_44100"], GOLDEN_P360
    print(block, "port:", got, "golden:", golden)  # shown with pytest -s
    for k, v in golden.items():
        assert abs(got[k] - v) < TOL[k], (k, got[k], v)


def test_resume_skips_journaled_files(tmp_path, monkeypatch):
    """evaluate(resume=True) takes every file already in the journal from
    it and scores nothing again; the results are the first run's."""
    spk = tmp_path / "data" / "p000"
    spk.mkdir(parents=True)
    for i, dur in enumerate([0.3, 0.5]):
        write_wav(str(spk / f"u{i}.wav"), speechlike(dur, 44100, seed=70 + i), 44100)
    monkeypatch.chdir(tmp_path)
    helper = ssr_eval_tpu_torch.SSR_Eval_Helper(
        BatchedTestee(), 44100, 44100, test_name="resume", test_data_root=str(tmp_path / "data"),
        setting_fft={"cutoff_freq": [4000]}, auto_download=False, batch_size=2, device="cpu",
    )
    first = helper.evaluate(verbose=False)
    scored = helper.engine.stats.utterances
    again = helper.evaluate(resume=True, verbose=False)
    assert helper.engine.stats.utterances == scored == 2
    assert again == first


def test_unported_family_raises(tmp_path):
    """Every family of the reference builds (no NotImplementedError is
    left); a family the package does not know raises ValueError."""
    from ssr_eval_tpu_torch.degrade.plan import DegradationSpec

    helper = ssr_eval_tpu_torch.SSR_Eval_Helper(
        BatchedTestee(), 44100, 44100, test_data_root=str(tmp_path),
        setting_lowpass_filtering={"filter": ["butter"], "cutoff_freq": [4000], "filter_order": [4]},
        setting_subsampling={"cutoff_freq": [4000]}, setting_mp3_compression={"low_kbps": [32]},
        setting_fft={"cutoff_freq": [4000]}, auto_download=False, device="cpu",
    )
    assert [s.family for s in helper.specs] == ["iir", "subsampling", "mp3", "fft"]
    with pytest.raises(ValueError, match="unknown degradation family 'gsm'"):
        EvalEngine([DegradationSpec("proc_x", "gsm", None, 8000, 1, 44100)], 44100, 44100, 44100,
                   BatchedTestee(), device="cpu")


def test_preprocess_matches_jax(vctk):
    """helper.preprocess: decode + 48 -> 44.1 kHz load resample + the fft
    degradation of one file, through both packages."""
    kw = dict(input_sr=44100, output_sr=44100, test_data_root=vctk,
              setting_fft={"cutoff_freq": [2000, 8000]}, auto_download=False)
    p = _files(vctk)[0]
    want = ssr_eval_tpu.SSR_Eval_Helper(ssr_eval_tpu.BasicTestee(), **kw).preprocess(p, 44100)
    got = ssr_eval_tpu_torch.SSR_Eval_Helper(
        ssr_eval_tpu_torch.BasicTestee(), device="cpu", **kw
    ).preprocess(p, 44100)
    assert list(got) == list(want) == ["proc_fft_4000_44100", "proc_fft_16000_44100"]
    for k in want:
        assert got[k].shape == want[k].shape
        assert np.abs(got[k] - want[k]).max() < 1e-5, k


def test_kaiser_best_load_matches_jax(vctk):
    """The windowed-sinc ('kaiser_best') bank: the same plan, and the same
    48 -> 44.1 kHz load of a fixture file."""
    from ssr_eval_tpu.dsp.resample import windowed_sinc_plan as j_plan
    from ssr_eval_tpu.io.audio import load as j_load
    from ssr_eval_tpu_torch.dsp.resample import windowed_sinc_plan
    from ssr_eval_tpu_torch.io.audio import load

    np.testing.assert_array_equal(windowed_sinc_plan(48000, 44100, 4096).Wd, j_plan(48000, 44100, 4096).Wd)
    p = _files(vctk)[1]
    got, sr = load(p, sr=44100, res_type="kaiser_best")
    want, jsr = j_load(p, sr=44100, res_type="kaiser_best")
    assert sr == jsr == 44100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_batched_testee_single_utterance_bridge():
    """BatchedTestee.infer runs one utterance through infer_batch."""
    t = NoisyTestee(torch.from_numpy(NOISE))
    x = np.linspace(-0.5, 0.5, 5000, dtype=np.float32)
    np.testing.assert_allclose(t.infer(x), x + NOISE[:5000], rtol=0, atol=1e-7)
    np.testing.assert_array_equal(BatchedTestee().infer(x), x)
