"""The port's IIR and subsampling degraders (plain PyTorch on the CPU)
against scipy in float64 and against the JAX package on the same numpy
inputs.

Tolerances: waveforms within 1e-4 of max|ref| of scipy's float64
sosfiltfilt / resample_poly (as tests/test_filters.py and
tests/test_degrade.py hold the JAX package); port vs JAX within 1e-5 of
max|ref| (both float32, different FFTs); host design arrays bit-identical.
Each case runs at two bucket lengths with two utterance lengths per batch,
so an off-by-one at the traced edges shows in the tail.
"""

import functools
import warnings

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly
from scipy.signal import sosfiltfilt as scipy_sff

import jax
import jax.numpy as jnp

from ssr_eval_tpu.degrade import apply as japply
from ssr_eval_tpu.degrade.plan import DegradationSpec as JSpec
from ssr_eval_tpu.degrade.plan import expand_settings as j_expand
from ssr_eval_tpu.dsp import filters as jfilters
from ssr_eval_tpu_torch.degrade import apply as tapply
from ssr_eval_tpu_torch.degrade.plan import DegradationSpec, expand_settings
from ssr_eval_tpu_torch.dsp import filters as tfilters

CPU = torch.device("cpu")
LENGTHS = (20011, 14999)  # two utterances per batch
BUCKETS = (20480, 24000)


def _batch(lmax, seed=0, lengths=LENGTHS):
    rng = np.random.default_rng(seed)
    x = np.zeros((len(lengths), lmax), np.float32)
    for j, n in enumerate(lengths):
        t = np.arange(n) / 44100.0
        x[j, :n] = (
            0.4 * np.sin(2 * np.pi * 300 * t)
            + 0.3 * np.sin(2 * np.pi * 5000 * t + 1.0)
            + 0.2 * np.sin(2 * np.pi * 15000 * t + 2.0)
            + 0.05 * rng.standard_normal(n)
        )
    return x


def _port(fkey, spec, x, lengths, params=None):
    lmax = x.shape[1]
    if params is None:
        params = tapply.spec_params(spec, lmax, CPU)
    fn = tapply.build_family_apply(fkey, lmax)
    return fn(None, torch.from_numpy(x), torch.tensor(lengths), params).numpy()


@functools.lru_cache(maxsize=None)
def _jax_degrader(fkey, lmax):
    return jax.jit(jax.vmap(japply.build_family_degrader(fkey, lmax), in_axes=(0, 0, None)))


def _jax(fkey, spec, x, lengths, params=None):
    lmax = x.shape[1]
    if params is None:
        params = japply.spec_params(JSpec(*spec), lmax)
    fn = _jax_degrader(fkey, lmax)
    return np.asarray(fn(jnp.asarray(x), jnp.asarray(lengths, jnp.int32), params))


@pytest.mark.parametrize("path", ["blocked", "monolithic"])
@pytest.mark.parametrize("ftype", ["butter", "cheby1", "ellip", "bessel"])
def test_iir_degrader_matches_scipy_and_jax(ftype, path):
    """4 designs x 2 orders x 2 cutoffs at two bucket lengths, through the
    overlap-save path (sosfiltfilt_blocked) and the monolithic one
    (sosfiltfilt_dynamic)."""
    worst_ref, worst_jax = 0.0, 0.0
    for lmax in BUCKETS:
        x = _batch(lmax, seed=lmax)
        for order in (4, 8):
            for cutoff in (2000, 8000):
                spec = DegradationSpec("k", "iir", ftype, 2 * cutoff, order, 44100)
                if path == "blocked":
                    fkey = tapply.family_key(spec)
                    assert fkey == japply.family_key(JSpec(*spec)) and fkey[1] is not None
                    got = _port(fkey, spec, x, LENGTHS)
                    want = _jax(fkey, spec, x, LENGTHS)
                else:
                    fkey = ("iir", None)
                    a = tapply.iir_host_arrays(spec, lmax, None)
                    tp = {"edge": a["edge"], "H": tfilters.complex_from_parts(a["Hr"], a["Hi"], CPU),
                          "r": torch.from_numpy(a["r"])}
                    jp = {"edge": jnp.int32(a["edge"]), "Hr": jnp.asarray(a["Hr"]),
                          "Hi": jnp.asarray(a["Hi"]), "r": jnp.asarray(a["r"])}
                    got = _port(fkey, spec, x, LENGTHS, tp)
                    want = _jax(fkey, spec, x, LENGTHS, jp)
                sos = tfilters.design_lowpass_sos(ftype, order, cutoff, 44100)
                for j, n in enumerate(LENGTHS):
                    ref = scipy_sff(sos, x[j, :n].astype(np.float64))
                    scale = np.abs(ref).max()
                    worst_ref = max(worst_ref, np.abs(got[j, :n] - ref).max() / scale)
                    worst_jax = max(worst_jax, np.abs(got[j, :n] - want[j, :n]).max() / scale)
                    assert np.all(got[j, n:] == 0.0)
    print(ftype, path, "vs scipy", worst_ref, "vs JAX", worst_jax)  # shown with pytest -s
    assert worst_ref < 1e-4 and worst_jax < 1e-5


def test_plan_sosfiltfilt_matches_scipy():
    """sosfiltfilt with a bucket plan (the lowpass_filter / bandpass path),
    including a bandpass design (edge 63 > the lowpass maximum)."""
    x = _batch(24000, seed=3)
    lengths = torch.tensor(LENGTHS)
    for sos in (
        tfilters.design_lowpass_sos("cheby2", 6, 8000.0, 44100),
        tfilters.design_bandpass_sos("ellip", 10, 1000, 6000, 44100),
    ):
        plan = tfilters.make_filtfilt_plan(sos, 24000)
        H, r = tfilters.plan_device_arrays(plan, CPU)
        got = tfilters.sosfiltfilt(torch.from_numpy(x), lengths, plan, H, r).numpy()
        for j, n in enumerate(LENGTHS):
            ref = scipy_sff(sos, x[j, :n].astype(np.float64))
            assert np.abs(got[j, :n] - ref).max() / np.abs(ref).max() < 1e-4
            assert np.all(got[j, n:] == 0.0)


SWEEP = dict(
    setting_lowpass_filtering={"filter": ["butter", "cheby", "ellip", "bessel"],
                               "cutoff_freq": [2000], "filter_order": [1, 10]},
    setting_subsampling={"cutoff_freq": [4000, 44100]},
    setting_fft={"cutoff_freq": [4000]},
    setting_mp3_compression={"low_kbps": [32]},
)


@pytest.mark.parametrize("sr", [44100, 48000])
def test_spec_params_and_family_key_match_jax(sr):
    """Family keys equal the JAX package's (so the grouping is the same),
    and every iir spec's host arrays are bit-identical to its spec_params."""
    specs = expand_settings(sr=sr, **SWEEP)
    jspecs = j_expand(sr=sr, **SWEEP)
    assert [tuple(s) for s in specs] == [tuple(s) for s in jspecs]
    lmax = 20480
    for s, js in zip(specs, jspecs):
        assert tapply.family_key(s) == japply.family_key(js), s.key
        if s.family == "iir":
            a = tapply.iir_host_arrays(s, lmax, tapply.iir_block_size(s))
            jp = japply.spec_params(js, lmax)
            assert a["edge"] == int(jp["edge"])
            for k in ("Hr", "Hi", "r"):
                np.testing.assert_array_equal(a[k], np.asarray(jp[k]), err_msg=f"{s.key} {k}")
            p = tapply.spec_params(s, lmax, CPU)
            np.testing.assert_array_equal(p["H"].real.numpy(), a["Hr"])
            np.testing.assert_array_equal(p["H"].imag.numpy(), a["Hi"])
        elif s.family == "fft":
            assert tapply.spec_params(s, lmax, CPU)["cut"] == int(japply.spec_params(js, lmax)["cut"])


def test_blocked_truncation_warns_like_jax():
    """A block shorter than the response: blocked_plan_arrays keeps the
    warning, reports the same tail masses, and returns the same arrays."""
    sos = tfilters.design_lowpass_sos("ellip", 10, 1000.0, 44100)
    plan = tfilters.make_filtfilt_plan(sos, 16384, edge_max=64)
    assert plan.m > 1024
    with pytest.raises(ValueError, match="exceeds block"):
        tfilters.blocked_plan_arrays(plan, 1024)
    with warnings.catch_warnings(record=True) as got_w:
        warnings.simplefilter("always")
        got = tfilters.blocked_plan_arrays(plan, 1024, truncate=True)
    with warnings.catch_warnings(record=True) as want_w:
        warnings.simplefilter("always")
        want = jfilters.blocked_plan_arrays(jfilters.make_filtfilt_plan(sos, 16384, edge_max=64), 1024, truncate=True)
    assert [str(w.message) for w in got_w] == [str(w.message) for w in want_w]
    assert len(got_w) == 1 and got_w[0].category is RuntimeWarning
    for a, b in zip((*got[0], got[1]), (*want[0], want[1])):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("sr", [44100, 48000])
def test_subsampling_matches_scipy_and_jax(sr):
    """Down then up with fs_ori = 44100 whatever the rate (so 48 kHz input
    at an 8 kHz cutoff goes through int(8000 / 24000 * 44100) = 14700 Hz)."""
    for lmax in BUCKETS:
        x = _batch(lmax, seed=sr + lmax)
        for highcut in (4000, 8000):
            spec = DegradationSpec("k", "subsampling", None, 2 * highcut, 1, sr)
            fkey = tapply.family_key(spec)
            got = _port(fkey, spec, x, LENGTHS)
            want = _jax(fkey, spec, x, LENGTHS)
            fs_down = tapply.subsampling_rate(spec.cutoff, sr)
            assert fs_down == int(highcut / int(sr / 2) * 44100)
            for j, n in enumerate(LENGTHS):
                y = resample_poly(x[j, :n].astype(np.float64), fs_down, 44100)
                ref = resample_poly(y, 44100, fs_down)[:n]
                scale = np.abs(ref).max()
                assert np.abs(got[j, :n] - ref).max() / scale < 1e-4, (sr, highcut)
                assert np.abs(got[j, :n] - want[j, :n]).max() / scale < 1e-5, (sr, highcut)
                assert np.all(got[j, n:] == 0.0)


def test_unknown_family_key_raises():
    with pytest.raises(ValueError, match="unknown degradation family"):
        tapply.family_key(DegradationSpec("k", "gsm", None, 8000, 1, 44100))
