"""ssr_eval_tpu_torch.dsp.spectral (plain PyTorch on the CPU) vs the JAX
package's spectral functions on the same bucketed buffers.

Buffers hold true lengths shorter than the bucket, so the traced-length
reflect padding, framing and iSTFT tail masks are all exercised.  STFT
tolerance: 1e-5 of the largest magnitude (float32 rfft forms agree to
~1e-6 there); iSTFT and the degrade round trip: 1e-5 of the largest
sample.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssr_eval_tpu.degrade import apply as jdeg
from ssr_eval_tpu.degrade.plan import expand_settings as j_expand
from ssr_eval_tpu.dsp import spectral as jsp
from ssr_eval_tpu_torch.degrade import apply as tdeg
from ssr_eval_tpu_torch.degrade.plan import expand_settings as t_expand
from ssr_eval_tpu_torch.dsp import spectral as tsp
from ssr_eval_tpu_torch.utils.bucket import bucket_length

CONFIGS = [(2048, 441), (2229, 480), (743, 160), (2048, 512)]
STFT_TOL = 1e-5
WAVE_TOL = 1e-5


def _buffers(seed, n=3, lmax=None):
    """[n, Lmax] zero-padded speech-band buffers with true lengths < Lmax."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(6000, 16000, size=n)
    lmax = lmax or bucket_length(int(lens.max()) + 1)
    x = np.zeros((n, lmax), np.float32)
    for i, L in enumerate(lens):
        t = np.arange(L) / 44100.0
        x[i, :L] = (
            0.4 * np.sin(2 * np.pi * (300 + 50 * i) * t)
            + 0.1 * np.sin(2 * np.pi * 7000 * t)
            + 0.02 * rng.standard_normal(L)
        )
    return x, lens.astype(np.int64)


def _valid_rows(cfg, lens, mf):
    return [min(int(tsp.n_frames_for_length(cfg, int(L))), mf) for L in lens]


@pytest.mark.parametrize("n_fft,hop", CONFIGS)
def test_stft_real_imag_and_magnitude_match_jax(n_fft, hop):
    cfg_t = tsp.StftConfig(n_fft=n_fft, hop=hop)
    cfg_j = jsp.StftConfig(n_fft=n_fft, hop=hop)
    x, lens = _buffers(n_fft + hop)
    mf = cfg_t.max_frames(x.shape[1])
    jr, ji = jax.vmap(lambda a, n: jsp.stft_real_imag(a, n, cfg_j, mf))(
        jnp.asarray(x), jnp.asarray(lens, jnp.int32)
    )
    jm = jax.vmap(lambda a, n: jsp.stft_magnitude(a, n, cfg_j, mf))(
        jnp.asarray(x), jnp.asarray(lens, jnp.int32)
    )
    tr, ti = tsp.stft_real_imag(torch.from_numpy(x), torch.from_numpy(lens), cfg_t, mf)
    tm = tsp.stft_magnitude(torch.from_numpy(x), torch.from_numpy(lens), cfg_t, mf)
    assert tuple(tm.shape) == (x.shape[0], mf, cfg_t.n_bins)
    jr, ji, jm = np.asarray(jr), np.asarray(ji), np.asarray(jm)
    for b, nf in enumerate(_valid_rows(cfg_t, lens, mf)):
        scale = jm[b, :nf].max()
        assert np.abs(tr[b, :nf].numpy() - jr[b, :nf]).max() / scale < STFT_TOL
        assert np.abs(ti[b, :nf].numpy() - ji[b, :nf]).max() / scale < STFT_TOL
        assert np.abs(tm[b, :nf].numpy() - jm[b, :nf]).max() / scale < STFT_TOL


@pytest.mark.parametrize("n_fft,hop", CONFIGS)
def test_istft_matches_jax(n_fft, hop):
    """Inverse of a frame-masked, band-limited spectrum at traced lengths."""
    cfg_t = tsp.StftConfig(n_fft=n_fft, hop=hop)
    cfg_j = jsp.StftConfig(n_fft=n_fft, hop=hop)
    x, lens = _buffers(7 * n_fft + hop)
    lmax = x.shape[1]
    mf = cfg_t.max_frames(lmax)
    xr, xi = tsp.stft_real_imag(torch.from_numpy(x), torch.from_numpy(lens), cfg_t, mf)
    nf = tsp.n_frames_for_length(cfg_t, torch.from_numpy(lens))
    keep = (torch.arange(mf)[None, :, None] < nf[:, None, None]) & (
        torch.arange(cfg_t.n_bins)[None, None, :] < cfg_t.n_bins // 3
    )
    real = (xr * keep).numpy()
    imag = (xi * keep).numpy()
    want = jax.vmap(lambda r, i, n: jsp.istft(r, i, n, cfg_j, lmax))(
        jnp.asarray(real), jnp.asarray(imag), jnp.asarray(lens, jnp.int32)
    )
    got = tsp.istft(torch.from_numpy(real), torch.from_numpy(imag), torch.from_numpy(lens), cfg_t, lmax)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() < WAVE_TOL
    for b, L in enumerate(lens):
        assert not got[b, L:].any()  # tail mask


def test_fft_degrade_round_trip_matches_jax():
    """The fft family (STFT 2048/441 -> bin+frame mask -> iSTFT), once per
    cutoff of a sweep, through both packages' degraders."""
    x, lens = _buffers(11)
    lmax = x.shape[1]
    specs_t = t_expand(setting_fft={"cutoff_freq": [2000, 8000, 24000, 44100]}, sr=44100)
    specs_j = j_expand(setting_fft={"cutoff_freq": [2000, 8000, 24000, 44100]}, sr=44100)
    assert [s.key for s in specs_t] == [s.key for s in specs_j]
    deg_t = tdeg.build_family_degrader(("fft",), lmax)
    deg_j = jax.vmap(jdeg.build_family_degrader(("fft",), lmax), in_axes=(0, 0, None))
    for st, sj in zip(specs_t, specs_j):
        pt = tdeg.spec_params(st, lmax, torch.device("cpu"))
        pj = jdeg.spec_params(sj, lmax)
        assert pt["cut"] == int(pj["cut"])
        got = deg_t(torch.from_numpy(x), torch.from_numpy(lens), pt).numpy()
        want = np.asarray(deg_j(jnp.asarray(x), jnp.asarray(lens, jnp.int32), pj))
        assert np.abs(got - want).max() / np.abs(x).max() < WAVE_TOL, st.key


def test_reflect_extend_matches_jax():
    x, lens = _buffers(3)
    got = tsp._extend(torch.from_numpy(x), torch.from_numpy(lens), 1024).numpy()
    want = np.stack([np.asarray(jsp._extend(jnp.asarray(r), int(n), 1024)) for r, n in zip(x, lens)])
    np.testing.assert_array_equal(got, want)


def test_unported_families_raise():
    """Every family of the reference has its key, equal to the JAX
    package's; only a family neither package knows raises."""
    spec = t_expand(setting_subsampling={"cutoff_freq": [8000]}, sr=44100)[0]
    assert tdeg.family_key(spec) == jdeg.family_key(j_expand(setting_subsampling={"cutoff_freq": [8000]}, sr=44100)[0])
    with pytest.raises(ValueError, match="unknown degradation family"):
        tdeg.family_key(spec._replace(family="gsm"))
