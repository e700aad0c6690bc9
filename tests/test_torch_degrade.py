"""The whole degradation matrix through the port's harness (plain PyTorch on
the CPU) against the JAX package: a mixed-family sweep (four IIR designs,
subsampling, mp3 and fft), its batch-composition invariance, the
multi-family golden run, `preprocess` for every family and the
`host_float64` metrics backend.

The mixed sweep runs 48 kHz end to end on a broadband NoisyTestee, so the
input and ground-truth resamplers are identities: both packages hand the
mp3 codec the same int16-exact samples (a codec turns a 1e-7 input change
into a different bit allocation), and no target spectrum sits at a float32
floor near Nyquist.  Per-pair tolerance: PARITY of test_torch_harness.py.
"""

import os

import numpy as np
import pytest
import torch

import ssr_eval_tpu
import ssr_eval_tpu_torch
from ssr_eval_tpu.degrade.plan import expand_settings as j_expand
from ssr_eval_tpu.harness.engine import EvalEngine as JEngine
from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk, speechlike
from ssr_eval_tpu_torch.harness.testee import BatchedTestee, state_from_numpy
from ssr_eval_tpu_torch.io import mp3_lame
from ssr_eval_tpu_torch.io.audio import write_flac
from tests.test_golden_synthetic import GOLDEN_FAMILIES, TOL
from tests.test_torch_harness import NOISE, PARITY, JaxNoisyTestee, NoisyTestee

METRICS = ("lsd", "log_sispec", "sispec", "ssim")
SR = 48000
MIXED = dict(
    setting_lowpass_filtering={"filter": ["butter", "cheby", "ellip", "bessel"],
                               "cutoff_freq": [4000], "filter_order": [8]},
    setting_subsampling={"cutoff_freq": [4000]},
    setting_mp3_compression={"low_kbps": [32]},
    setting_fft={"cutoff_freq": [8000]},
)
MIXED_KEYS = [
    "proc_bw_8000_8_48000", "proc_ch_8000_8_48000", "proc_el_8000_8_48000",
    "proc_bessel_8000_8_48000", "proc_subsampling_8000_48000", "proc_mp3_32_48000",
    "proc_fft_16000_48000",
]
# The multi-family golden run with the identity testee: the IIR estimates'
# stop bands sit at each implementation's float32 FFT rounding floor, which
# moves only LSD and log-SiSpec (PARITY.md deviation 4).  The port's floor
# puts them 0.299-0.356 (LSD) and 0.161-0.253 (log-SiSpec) off the JAX
# package's CPU pins here, and 0.396-0.459 / 0.262-0.383 on an H100
# (cuFFT); subsampling stays inside TOL.  The float64 truth lies beyond the
# port on the far side of the pins (LSD 7.85-8.38 vs pins 6.24-6.81;
# chip_smoke.py's families phase), so the gap is the pins' floor, not a
# fault of the port.  Held within ~1.3x of the card's maxima; SiSpec and
# SSIM stay inside TOL.
FLOOR_TOL = {"lsd": 0.6, "log_sispec": 0.5}

needs_lame = pytest.mark.skipif(not mp3_lame.available(), reason="libmp3lame not present")


def _write_mixed_data(root):
    """2 speakers x 2 files of 48 kHz FLAC in two length buckets, so both
    packages compile few programs and each batch carries padding rows."""
    for si, spk in enumerate(["p001", "p002"]):
        os.makedirs(os.path.join(root, spk))
        for fi, dur in enumerate([0.45, 0.6]):
            x = speechlike(dur + 0.01 * si, SR, seed=10 * si + fi)
            write_flac(os.path.join(root, spk, f"{spk}_{fi}.flac"), x, SR)
    return root


def _files(root):
    return sorted(
        os.path.join(root, d, f) for d in os.listdir(root) for f in os.listdir(os.path.join(root, d))
        if "proc" not in f
    )


def _one_bucket(root):
    """The two shorter files: one length bucket, so one batch."""
    return [p for p in _files(root) if p.endswith("_0.flac")]


@pytest.fixture(scope="module")
def mixed(tmp_path_factory):
    root = _write_mixed_data(str(tmp_path_factory.mktemp("mixed") / "data"))
    kw = dict(input_sr=SR, output_sr=SR, evaluation_sr=SR, test_name="mixed",
              test_data_root=root, auto_download=False, batch_size=4, **MIXED)
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("mixed_run"))
    try:
        want = ssr_eval_tpu.SSR_Eval_Helper(JaxNoisyTestee(), **kw).evaluate(verbose=False)
        helper = ssr_eval_tpu_torch.SSR_Eval_Helper(
            NoisyTestee(state_from_numpy(NOISE, "cpu")), device="cpu", **kw
        )
        got = helper.evaluate(verbose=False)
    finally:
        os.chdir(cwd)
    return want, got, helper, root


@needs_lame
def test_mixed_sweep_matches_jax(mixed):
    want, got, _, _ = mixed
    worst = {}
    n = 0
    for spk, files in want.items():
        if spk in ("each_speaker", "averaged"):
            continue
        for fname, specs in files.items():
            for key, m in specs.items():
                fam = key.split("_")[1]
                for k in METRICS:
                    d = abs(got[spk][fname][key][k] - m[k])
                    worst[(fam, k)] = max(worst.get((fam, k), 0.0), d)
                    assert np.isfinite(got[spk][fname][key][k]) and d <= PARITY[k], (fname, key, k, d)
                n += 1
    assert n == 4 * len(MIXED_KEYS)
    print("max |port - JAX| per family and metric:", worst)  # shown with pytest -s


@needs_lame
def test_mixed_sweep_keys_order_and_schema(mixed):
    want, got, _, _ = mixed

    def shape(d):
        return {k: shape(v) for k, v in d.items()} if isinstance(d, dict) else type(d).__name__

    assert shape(got) == shape(want)
    assert list(got["averaged"]) == list(want["averaged"]) == MIXED_KEYS
    for spk in ("p001", "p002"):
        for fname in want[spk]:
            assert list(got[spk][fname]) == list(want[spk][fname]) == MIXED_KEYS


@needs_lame
def test_mixed_sweep_batch_composition_invariance(mixed):
    """Each file alone (batch 1) vs inside the sweep's batches of 4 (two
    real rows and two padding rows per bucket): within 1e-5."""
    _, _, helper, root = mixed
    specs = expand_settings(sr=SR, **helper_settings(helper))
    one = EvalEngine(specs, SR, SR, SR, NoisyTestee(state_from_numpy(NOISE, "cpu")), batch_size=1, device="cpu")
    r_all = helper.engine.evaluate_files(_files(root))
    worst = 0.0
    for p in _files(root):
        r_one = one.evaluate_files([p])[p]
        assert list(r_one) == MIXED_KEYS
        for key in MIXED_KEYS:
            for k in METRICS:
                worst = max(worst, abs(r_all[p][key][k] - r_one[key][k]))
    print("max |alone - in batch|:", worst)  # shown with pytest -s
    assert worst < 1e-5


def helper_settings(helper):
    """The helper's settings with the doubled cutoffs (expand_settings input)."""
    return dict(
        setting_lowpass_filtering=helper.setting_lowpass_filtering,
        setting_subsampling=helper.setting_subsampling,
        setting_mp3_compression=helper.setting_mp3_compression,
        setting_fft=helper.setting_fft,
    )


@pytest.fixture(scope="module")
def families_run(tmp_path_factory):
    root = ensure_synthetic_vctk(str(tmp_path_factory.mktemp("port_fam") / "vctk_test"), files_per_speaker=2)
    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("port_fam_run"))
    try:
        return ssr_eval_tpu_torch.SSR_Eval_Helper(
            ssr_eval_tpu_torch.BasicTestee(),
            input_sr=44100, output_sr=44100, evaluation_sr=44100,
            test_name="golden_families", test_data_root=root,
            setting_lowpass_filtering={"filter": ["butter", "cheby", "ellip", "bessel"],
                                       "cutoff_freq": [8000], "filter_order": [8]},
            setting_subsampling={"cutoff_freq": [8000]},
            auto_download=False, batch_size=4, device="cpu",
        ).evaluate(limit_test_nums=2, limit_test_speaker=-1, verbose=False)
    finally:
        os.chdir(cwd)


def test_golden_iir_and_subsampling_families(families_run):
    """The JAX package's multi-family golden run through the port: SiSpec
    and SSIM inside the golden TOL; LSD and log-SiSpec, floor-dominated in
    the IIR stop band, within FLOOR_TOL of the JAX package's CPU pins
    (subsampling inside TOL for all four)."""
    assert list(families_run["averaged"]) == list(GOLDEN_FAMILIES)
    for key, pins in GOLDEN_FAMILIES.items():
        got = families_run["averaged"][key]
        print(key, {m: round(got[m] - v, 6) for m, v in pins.items()})  # shown with pytest -s
        for m, v in pins.items():
            tol = FLOOR_TOL[m] if m in FLOOR_TOL and "subsampling" not in key else TOL[m]
            assert abs(got[m] - v) < tol, (key, m, got[m], v)


@needs_lame
def test_preprocess_every_family_matches_jax(tmp_path):
    """helper.preprocess (decode, load resample, then every family's
    degradation, mp3 with its cache file) through both packages."""
    root = _write_mixed_data(str(tmp_path / "data"))
    settings = dict(
        setting_lowpass_filtering={"filter": ["butter", "ellip"], "cutoff_freq": [4000], "filter_order": [8]},
        setting_subsampling={"cutoff_freq": [4000]},
        setting_mp3_compression={"low_kbps": [64]},
        setting_fft={"cutoff_freq": [8000]},
    )
    kw = dict(input_sr=44100, output_sr=44100, test_data_root=root, auto_download=False, **settings)
    p = _files(root)[0]
    want = ssr_eval_tpu.SSR_Eval_Helper(ssr_eval_tpu.BasicTestee(), **kw).preprocess(p, 44100)
    cache = os.path.join(os.path.dirname(p), "p001_0_proc_mp3_64_44100.flac")
    os.remove(cache)
    helper = ssr_eval_tpu_torch.SSR_Eval_Helper(ssr_eval_tpu_torch.BasicTestee(), device="cpu", **kw)
    got = helper.preprocess(p, 44100)
    assert os.path.exists(cache) and helper.cache_file_name("proc_mp3_64_44100", p) == cache
    assert list(got) == list(want) == [
        "proc_bw_8000_8_44100", "proc_el_8000_8_44100", "proc_subsampling_8000_44100",
        "proc_mp3_64_44100", "proc_fft_16000_44100",
    ]
    for k in want:
        assert got[k].shape == want[k].shape
        # Both loads are the same float64 resample_poly, so the codec sees
        # identical samples; the device families differ at float32 rounding.
        assert np.abs(got[k] - want[k]).max() <= 1e-5 * np.abs(want[k]).max(), k


def test_host_float64_backend_matches_jax(tmp_path):
    """metrics_backend="host_float64": float64 NumPy metrics over the
    device-produced waveforms, per pair within PARITY of the JAX engine's
    same mode, and near the float32 device metrics."""
    root = _write_mixed_data(str(tmp_path / "data"))
    paths = _one_bucket(root)
    settings = dict(
        setting_lowpass_filtering={"filter": ["cheby"], "cutoff_freq": [8000], "filter_order": [6]},
        setting_fft={"cutoff_freq": [8000]},
    )
    specs = expand_settings(sr=SR, **settings)
    jspecs = j_expand(sr=SR, **settings)
    testee = NoisyTestee(state_from_numpy(NOISE, "cpu"))
    got = EvalEngine(specs, SR, SR, SR, testee, batch_size=2, device="cpu",
                     metrics_backend="host_float64").evaluate_files(paths)
    dev = EvalEngine(specs, SR, SR, SR, testee, batch_size=2, device="cpu").evaluate_files(paths)
    want = JEngine(jspecs, SR, SR, SR, JaxNoisyTestee(), batch_size=2,
                   metrics_backend="host_float64").evaluate_files(paths)
    for p in paths:
        assert list(got[p]) == list(want[p]) == [s.key for s in specs]
        for s in specs:
            for k in METRICS:
                assert abs(got[p][s.key][k] - want[p][s.key][k]) <= PARITY[k], (p, s.key, k)
                assert abs(got[p][s.key][k] - dev[p][s.key][k]) <= 10 * PARITY[k], (p, s.key, k)
    with pytest.raises(ValueError, match="metrics_backend"):
        EvalEngine(specs, SR, SR, SR, testee, device="cpu", metrics_backend="float16")


def test_host_testee_mixed_families_match_device_testee(tmp_path):
    """The host-testee bridge degrades each spec with its own family's
    degrader (not the first spec's): an identity BasicTestee scores like
    the identity BatchedTestee through the fused path."""
    root = _write_mixed_data(str(tmp_path / "data"))
    paths = _one_bucket(root)
    specs = expand_settings(
        sr=SR, setting_lowpass_filtering={"filter": ["butter"], "cutoff_freq": [8000], "filter_order": [4]},
        setting_subsampling={"cutoff_freq": [6000]}, setting_fft={"cutoff_freq": [8000]},
    )
    host = EvalEngine(specs, SR, SR, SR, ssr_eval_tpu_torch.BasicTestee(), batch_size=2, device="cpu")
    fused = EvalEngine(specs, SR, SR, SR, BatchedTestee(), batch_size=2, device="cpu")
    rh, rf = host.evaluate_files(paths), fused.evaluate_files(paths)
    for p in paths:
        assert list(rh[p]) == [s.key for s in specs]
        for s in specs:
            for k in METRICS:
                assert abs(rh[p][s.key][k] - rf[p][s.key][k]) < 1e-4, (s.key, k)


def test_codec_pool_shuts_down_on_failure(tmp_path, monkeypatch):
    """A failing codec job propagates out of evaluate_files, and the engine
    leaves no codec thread running."""
    import threading

    from ssr_eval_tpu_torch.degrade import codec

    root = _write_mixed_data(str(tmp_path / "data"))
    monkeypatch.setattr(codec, "detect_backend", lambda: None)
    specs = expand_settings(sr=SR, setting_mp3_compression={"low_kbps": [32]},
                            setting_fft={"cutoff_freq": [8000]})
    eng = EvalEngine(specs, SR, SR, SR, BatchedTestee(), batch_size=2, device="cpu", io_workers=2)
    before = threading.active_count()
    with pytest.raises(codec.CodecUnavailableError):
        eng.evaluate_files(_files(root))
    for t in threading.enumerate():
        if t.name.startswith("ThreadPoolExecutor"):
            t.join(timeout=10)
    assert threading.active_count() <= before

