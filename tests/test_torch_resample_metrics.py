"""ssr_eval_tpu_torch resampling and metrics (plain PyTorch on the CPU) vs
the JAX package, scipy and the float64 oracles.

Tolerances: resample vs JAX 1e-6 absolute (same f64-designed filter, both
float32 matmuls); vs scipy's float64 resample_poly 5e-6 of the largest
sample (tests/test_resample.py's bound).  Metrics on identical
spectrograms vs JAX: 1e-5 relative; vs the float64 oracles: LSD and SSIM
1e-4, SiSpec 1e-3 dB.  Whole waveform pairs vs JAX: 1e-4 absolute or
relative (the two float32 FFT forms differ by ~1e-6 of the peak, which
low-magnitude bins turn into ~3e-5 of LSD).
"""

import numpy as np
import pytest
import torch
from scipy.signal import resample_poly as scipy_resample_poly

import jax
import jax.numpy as jnp

from ssr_eval_tpu.dsp import resample as jrs
from ssr_eval_tpu.metrics import kernels as jmk
from ssr_eval_tpu_torch.dsp import resample as trs
from ssr_eval_tpu_torch.metrics import host_reference
from ssr_eval_tpu_torch.metrics import kernels as tmk
from tests import oracles
from tests.oracles import lsd_np, sispec_np, ssim_np


def _sig(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 48000.0
    return (
        0.5 * np.sin(2 * np.pi * 440 * t)
        + 0.2 * np.sin(2 * np.pi * 9000 * t)
        + 0.02 * rng.standard_normal(n)
    ).astype(np.float32)


@pytest.mark.parametrize("sr_in,sr_out", [(48000, 44100), (44100, 48000), (48000, 16000)])
def test_apply_resample_matches_jax_and_scipy(sr_in, sr_out):
    lmax = 24576
    lens = np.array([lmax, 17501, 9000], np.int64)
    x = np.zeros((3, lmax), np.float32)
    for i, L in enumerate(lens):
        x[i, :L] = _sig(int(L), seed=i)
    plan = trs.resample_poly_plan(sr_in, sr_out, lmax)
    jplan = jrs.resample_poly_plan(sr_in, sr_out, lmax)
    np.testing.assert_array_equal(plan.Wd, jplan.Wd)
    out_len = int(plan.out_length(lmax))
    got, got_n = trs.apply_resample(
        torch.from_numpy(x), torch.from_numpy(lens), plan, out_len, torch.from_numpy(plan.Wd)
    )
    want, want_n = jax.vmap(
        lambda a, n: jrs.apply_resample(a, n, jplan, out_len, jnp.asarray(jplan.Wd))
    )(jnp.asarray(x), jnp.asarray(lens, jnp.int32))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert np.abs(got.numpy() - np.asarray(want)).max() < 1e-6
    for i, L in enumerate(lens):
        ref = scipy_resample_poly(x[i, :L].astype(np.float64), plan.up, plan.down)
        n = int(got_n[i])
        assert n == len(ref)
        assert np.abs(got[i, :n].numpy() - ref).max() / np.abs(ref).max() < 5e-6
        assert not got[i, n:].any()


def _spectrogram_pair(seed, T=60, F=200):
    rng = np.random.default_rng(seed)
    tgt = np.abs(rng.standard_normal((T, F))).astype(np.float32) + 0.01
    est = (tgt * np.exp(0.3 * rng.standard_normal((T, F)))).astype(np.float32)
    est[:, F // 2 :] *= 1e-3  # a lowpassed band: tiny but nonzero
    return est, tgt


def test_metric_reductions_match_jax_and_oracles():
    pairs = [_spectrogram_pair(s) for s in range(3)]
    est = np.stack([p[0] for p in pairs])
    tgt = np.stack([p[1] for p in pairs])
    T = est.shape[1]
    nf = np.array([T, T - 9, T - 20], np.int64)
    fmask = (np.arange(T)[None, :] < nf[:, None]).astype(np.float32)
    m2 = fmask[:, :, None]
    e, t = torch.from_numpy(est), torch.from_numpy(tgt)
    got = {
        "lsd": tmk._lsd(e, t, torch.from_numpy(fmask)),
        "sispec": tmk._sispec(e * torch.from_numpy(m2), t * torch.from_numpy(m2)),
        "ssim": tmk._ssim(e * torch.from_numpy(m2), t * torch.from_numpy(m2), torch.from_numpy(nf)),
    }
    for b in range(3):
        je, jt = jnp.asarray(est[b]), jnp.asarray(tgt[b])
        want = {
            "lsd": jmk._lsd(je, jt, jnp.asarray(fmask[b])),
            "sispec": jmk._sispec(je * m2[b], jt * m2[b]),
            "ssim": jmk._ssim(je * m2[b], jt * m2[b], int(nf[b])),
        }
        for k in got:
            w = float(want[k])
            assert abs(float(got[k][b]) - w) <= 1e-5 * max(1.0, abs(w)), (k, b)
        n = int(nf[b])
        assert abs(float(got["lsd"][b]) - lsd_np(est[b, :n], tgt[b, :n])) < 1e-4
        assert abs(float(got["sispec"][b]) - sispec_np(est[b, :n], tgt[b, :n])) < 1e-3
        assert abs(float(got["ssim"][b]) - ssim_np(est[b, :n], tgt[b, :n])) < 1e-4


@pytest.mark.parametrize("rate", [44100, 48000, 16000])
def test_spectral_metrics_match_jax(rate):
    """Waveform pairs of different lengths (truncate-to-min), through the
    |STFT| plain version and the four reductions."""
    cfg = tmk.metric_stft_config(rate)
    jcfg = jmk.metric_stft_config(rate)
    assert (cfg.n_fft, cfg.hop, cfg.win, cfg.pad) == (jcfg.n_fft, jcfg.hop, jcfg.win, jcfg.pad)
    lmax = 16384
    lens_e = np.array([16000, 12000, 9000], np.int64)
    lens_t = np.array([15000, 12500, 9000], np.int64)
    est = np.zeros((3, lmax), np.float32)
    tgt = np.zeros((3, lmax), np.float32)
    for i in range(3):
        tgt[i, : lens_t[i]] = _sig(int(lens_t[i]), seed=10 + i)
        # A degraded estimate: rescaled, with its own broadband floor.
        floor = np.random.default_rng(20 + i).standard_normal(lens_e[i]).astype(np.float32)
        est[i, : lens_e[i]] = 0.8 * _sig(int(lens_e[i]), seed=10 + i) + 0.05 * floor
    mf = cfg.max_frames(lmax)
    got = tmk.spectral_metrics(
        torch.from_numpy(est), torch.from_numpy(lens_e), torch.from_numpy(tgt), torch.from_numpy(lens_t), cfg, mf
    )
    want = jax.vmap(lambda a, na, b, nb: jmk.spectral_metrics(a, na, b, nb, jcfg, mf))(
        jnp.asarray(est), jnp.asarray(lens_e, jnp.int32), jnp.asarray(tgt), jnp.asarray(lens_t, jnp.int32)
    )
    for k in ("lsd", "log_sispec", "sispec", "ssim"):
        g = got[k].numpy()
        w = np.asarray(want[k])
        assert g.shape == (3,)
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("n_fft,hop", [(2048, 441), (2229, 480), (743, 160)])
def test_oracle_copy_equals_the_test_oracle(n_fft, hop):
    """metrics/host_reference.py (metrics_backend="host_float64") is a
    bit-identical copy of tests/oracles.py's float64 functions."""
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal(9000)
    y = x + 0.1 * rng.standard_normal(9000)
    Z = host_reference.stft_np(x, n_fft, hop)
    np.testing.assert_array_equal(Z, oracles.stft_np(x, n_fft, hop))
    for length in (len(x), None):
        np.testing.assert_array_equal(host_reference.istft_np(Z, n_fft, hop, length=length),
                                      oracles.istft_np(Z, n_fft, hop, length=length))
    est, tgt = np.abs(host_reference.stft_np(y, n_fft, hop)).T, np.abs(Z).T
    for name in ("lsd_np", "sispec_np", "ssim_np"):
        assert getattr(host_reference, name)(est, tgt) == getattr(oracles, name)(est, tgt), name
    log_e, log_t = np.log10(est + 1e-12), np.log10(tgt + 1e-12)
    assert host_reference.sispec_np(log_e, log_t) == oracles.sispec_np(log_e, log_t)
