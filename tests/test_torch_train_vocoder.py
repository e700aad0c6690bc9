"""The |STFT| backward and the port's vocoder training
(ssr_eval_tpu_torch.dsp.stft_kernel, models.train_vocoder on the CPU) vs the
JAX package's `jax.grad` of its stft_magnitude and its VocoderTrainer.

Sizes: TFGAN vocoders at 32 channels (gradients) and the SMALL_TFGAN preset
(export, probe), batch 2, 0.35 s crops (35 frames); inputs from NumPy seeds,
weights carried by convert.nvsr_state_from_flax.  Tolerances, and why:
- |STFT| backward within 1e-5 of max|JAX grad| (eps=1e-8) and of max|float64
  grad| on noise, at NVSR's 2048/441 and the 48 kHz (2229/480) and 16 kHz
  (743/160) metric STFTs: one float32 FFT each way (both sit at ~1e-6 of
  max).  On
  speech with a silent stretch, bins just above the eps floor carry a phase
  X/|X| that float32 gets only to ~1e-2, so both packages sit at ~2e-5 of
  max off float64 there: held to 1e-4 of the JAX gradient, and no further
  from float64 than 1.5x the JAX package's own error;
- the backward kernel's algorithm (the split path and Bluestein), emulated
  in NumPy float32 with the kernel's own tables, within 2e-6 of max|float64
  grad| (as the forward's emulation in tests/test_torch_stft_kernel.py);
  its segmented overlap-add equals the plain fixed-order one bit for bit;
- vocoder loss within 1e-5 relative; gradients per leaf within 1e-4 of the
  leaf's max|JAX grad|: float32 convolutions summed in another order;
- probe correlation within 1e-4: a Pearson correlation of float32 log-mels;
- exported state dicts exact; the JAX converter's vocoder within 1e-4 of
  max (tests/test_torch_models.py's module tolerance).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssr_eval_tpu.dsp import spectral as j_spectral
from ssr_eval_tpu.metrics import kernels as j_metrics
from ssr_eval_tpu.models import nvsr as j_nvsr
from ssr_eval_tpu.models import train_vocoder as j_tv
from ssr_eval_tpu.models import vocoder as j_voc
from ssr_eval_tpu.models.convert import vocoder_state_dict_to_flax
from ssr_eval_tpu_torch.dsp import spectral, stft_kernel
from ssr_eval_tpu_torch.dsp.stft_kernel import (
    StftMagnitudeFn,
    stft_magnitude_backward_kernel,
    stft_magnitude_backward_plain,
    stft_magnitude_plain,
)
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.metrics.kernels import metric_stft_config
from ssr_eval_tpu_torch.models import convert, testees
from ssr_eval_tpu_torch.models.nvsr import NVSR_STFT
from ssr_eval_tpu_torch.models.train_vocoder import SMALL_TFGAN, VocoderTrainer, export_torch_state_dict
from ssr_eval_tpu_torch.models.vocoder import TFGANConfig
from ssr_eval_tpu_torch.models.vocoder_check import probe_signal
from tests.test_torch_nvsr import one_torch_thread  # noqa: F401  (a fixture)
from tests.test_torch_stft_kernel import _c64, _stockham_np

STFT_GRAD_TOL = 1e-5
EMUL_TOL = 2e-6
GRAD_TOL = 1e-4
NARROW = dict(channels=32, res_dilations=(1, 3))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _rel(got, want):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _buffers(seed=0):
    """Two rows of different lengths with a silent stretch (bins on the
    eps floor, whose gradient is 0), zero-padded to one buffer."""
    a = speechlike(0.25, 44100, seed=seed)
    a[3000:7000] = 0.0
    b = 0.5 * speechlike(0.12, 44100, seed=seed + 1)
    return _pack(a, b)


def _noise(seed=0):
    """The same layout with noise: every bin far above the eps floor."""
    rng = np.random.default_rng(seed)
    a = (0.1 * rng.standard_normal(11025)).astype(np.float32)
    a[3000:7000] = 0.0
    return _pack(a, (0.05 * rng.standard_normal(5292)).astype(np.float32))


def _pack(a, b):
    x = np.zeros((2, 12000), np.float32)
    x[0, : len(a)] = a
    x[1, : len(b)] = b
    return x, np.asarray([len(a), len(b)])


# ----------------------------------------------------------------------
# the |STFT| backward


# (port config, JAX config): NVSR's 2048/441, and the 48 kHz (2229/480) and
# 16 kHz (743/160) metric STFTs, whose n_fft goes through Bluestein.
STFT_CONFIGS = {
    "nvsr": (NVSR_STFT, j_nvsr.NVSR_STFT),
    "48k": (metric_stft_config(48000), j_metrics.metric_stft_config(48000)),
    "16k": (metric_stft_config(16000), j_metrics.metric_stft_config(16000)),
}


# The speech case runs at 2048/441 only: near the eps floor torch's CPU
# float32 rfft at a non-power-of-two n_fft rounds several times worse than
# XLA's (9.2e-5 against 1.3e-5 of max off float64 at 2229/480), so "no
# further from float64 than the JAX package" holds only where both packages
# run a power-of-two FFT.
@pytest.mark.parametrize(
    "config,signal",
    [pytest.param("nvsr", "noise", id="noise"), pytest.param("nvsr", "speech", id="speech"),
     pytest.param("48k", "noise", id="48k-noise"), pytest.param("16k", "noise", id="16k-noise")],
)
def test_stft_backward_matches_jax_grad_and_float64(config, signal, one_torch_thread):
    """d sum(g * stft_magnitude(x, eps=1e-8)) / dx through _extend (reflect
    edges at each row's own length) vs jax.grad of the JAX package's
    stft_magnitude, and vs the same graph in float64."""
    x, n = _noise() if signal == "noise" else _buffers()
    cfg, j_cfg = STFT_CONFIGS[config]
    mf = cfg.max_frames(x.shape[1])
    g = np.random.default_rng(1).standard_normal((2, mf, cfg.n_bins)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    mag = spectral.stft_magnitude(xt, torch.from_numpy(n), cfg, mf, eps=1e-8)
    (got,) = torch.autograd.grad(mag, xt, torch.from_numpy(g))

    x64 = torch.from_numpy(x).double().requires_grad_(True)
    ext64 = spectral._framing_source(x64, torch.from_numpy(n), cfg, mf)
    win64 = torch.from_numpy(spectral._padded_window64(cfg.n_fft, cfg.win))
    mag64 = stft_magnitude_plain(ext64, cfg.n_fft, cfg.hop, mf, win64)
    (f64,) = torch.autograd.grad(torch.sqrt(torch.clamp(mag64 * mag64, min=1e-8)), x64, torch.from_numpy(g).double())

    def j_loss(xs):
        mags = jax.vmap(lambda xi, li: j_spectral.stft_magnitude(xi, li, j_cfg, mf, eps=1e-8))(
            xs, jnp.asarray(n))
        return jnp.sum(mags * jnp.asarray(g))

    want = np.asarray(jax.grad(j_loss)(jnp.asarray(x)))
    if signal == "noise":
        assert _rel(got, want) <= STFT_GRAD_TOL
        assert _rel(got.double(), f64.numpy()) <= STFT_GRAD_TOL
    else:
        assert _rel(got, want) <= 1e-4
        assert _rel(got.double(), f64.numpy()) <= 1.5 * _rel(want.astype(np.float64), f64.numpy())


def test_extend_passes_the_gradient_to_x():
    """_framing_source's reflect extension vs the JAX package's _extend:
    the gradient of a weighted sum reaches x, reflected edges included."""
    x, n = _buffers(4)
    pad = 1024
    w = np.random.default_rng(2).standard_normal((2, x.shape[1] + 2 * pad)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    ext = spectral._extend(xt, torch.from_numpy(n), pad)
    (got,) = torch.autograd.grad(ext, xt, torch.from_numpy(w))

    def j_sum(xs):
        exts = jax.vmap(lambda xi, li: j_spectral._extend(xi, li, pad))(xs, jnp.asarray(n))
        return jnp.sum(exts * jnp.asarray(w))

    want = np.asarray(jax.grad(j_sum)(jnp.asarray(x)))
    assert _rel(got, want) <= 1e-6
    # the reflected edges add to the samples they copy
    assert got[0, 1] != w[0, pad + 1]


def _bwd_frames_np(frames, win, g, n_fft):
    """Per-frame gradients as the backward kernel computes them, all float32
    with its tables.  Split path: the forward's Stockham FFT, the pair update
    (Z[k], Z[P-k]) -> (C[k], C[P-k]) and the inverse as conj(FFT(conj C)).
    Bluestein: the forward's two FFTs give F = c conj X, u = g conj F / |F|
    for k < K, then conj(FFT(u) D) -> FFT -> G and d frame = w Re(c G)."""
    plan = stft_kernel._fft_plan(n_fft)
    P, a = plan.fft_len, _c64(plan.table_a)
    k = np.arange(P // 2 + 1)
    j = P - k

    def split(zk, zr, ak):
        zc = np.conj(zr)
        return 0.5 * (zk + zc) + ak * (-0.5j * (zk - zc))

    def mag_grad(X, gg):
        m = np.abs(X).astype(np.float32)
        return np.where(m > 0, gg * X / np.where(m > 0, m, 1), 0).astype(np.complex64)

    out = []
    for row, gr in zip(frames, g):
        v = (row * win).astype(np.float32)
        if plan.kind == "bluestein":
            D = _c64(plan.table_b)
            y = np.zeros(P, np.complex64)
            y[:n_fft] = v * a
            F = _stockham_np(_stockham_np(y, plan.twiddle).conj() * D, plan.twiddle)
            u = np.zeros(P, np.complex64)
            u[: len(gr)] = mag_grad(np.conj(F[: len(gr)]), gr)
            G = _stockham_np(np.conj(_stockham_np(u, plan.twiddle) * D), plan.twiddle)
            out.append((win * (a * G[:n_fft]).real).astype(np.float32))
            continue
        Z = _stockham_np((v[0::2] + 1j * v[1::2]).astype(np.complex64), plan.twiddle)
        zk, zj = Z[k], Z[j & (P - 1)]
        hk, hj = mag_grad(split(zk, zj, a[k]), gr[k]), mag_grad(split(zj, zk, a[j]), gr[j])
        E = 0.5 * (hk + np.conj(hj))
        C = np.zeros(P, np.complex64)
        C[k] = E + 1j * (0.5 * (hk - np.conj(hj)) * np.conj(a[k]))
        C[j[1:]] = (np.conj(E) + 1j * (0.5 * (hj - np.conj(hk)) * np.conj(a[j])))[1:]
        C[0] = (hk[0].real + hj[0].real) + 1j * (hk[0].real - hj[0].real)
        F = _stockham_np(np.conj(C).astype(np.complex64), plan.twiddle)
        d = np.empty(n_fft, np.float32)
        d[0::2], d[1::2] = win[0::2] * F.real, -win[1::2] * F.imag
        out.append(d)
    return np.stack(out)


def _ola_np(dframes, L, hop):
    """The backward kernel's overlap-add: per sample, the covering frames
    in ascending order."""
    n_frames, n_fft = dframes.shape
    out = np.zeros(L, np.float32)
    for i in range(L):
        lo = (i - n_fft) // hop + 1 if i >= n_fft else 0
        for f in range(lo, min(n_frames - 1, i // hop) + 1):
            out[i] += dframes[f, i - f * hop]
    return out


def _segmented_ola_np(dframes, L, hop, seg, ring_len):
    """The kernel's fused overlap-add with its own index arithmetic: block s
    owns samples [s seg hop, (s+1) seg hop) (the last one to L) and adds the
    frames that cover them (its own and the halo before), in ascending
    order, into a float32 ring of ring_len slots (slot j mod ring_len);
    after frame f the samples below (f+1) hop are final: written out and
    their slots cleared for reuse."""
    mf, n_fft = dframes.shape
    n_seg = -(-mf // seg)
    out = np.full(L, np.nan, np.float32)
    for s in range(n_seg):
        j0 = s * seg * hop
        j1 = L if s == n_seg - 1 else j0 + seg * hop
        f_begin = (j0 - n_fft) // hop + 1 if j0 >= n_fft else 0
        f_end = min(mf, (s + 1) * seg)
        ring = np.zeros(ring_len, np.float32)
        written = j0
        for f in range(f_begin, f_end):
            lo, hi = max(j0, f * hop), min(j1, f * hop + n_fft)
            if lo < hi:
                ring[np.arange(lo, hi) & (ring_len - 1)] += dframes[f, lo - f * hop : hi - f * hop]
            done = j1 if f == f_end - 1 else min(j1, (f + 1) * hop)
            # ascending, as each thread writes its own samples: past the
            # last frame's end a slot is read again one ring later
            for c in range(written, done, ring_len):
                slots = np.arange(c, min(c + ring_len, done)) & (ring_len - 1)
                out[c : c + len(slots)] = ring[slots]
                ring[slots] = 0.0
            written = max(written, done)
    return out


@pytest.mark.parametrize(
    "n_fft,hop,mf",
    [(2, 1, 5), (4, 3, 4), (32, 7, 6), (512, 128, 5), (2048, 441, 4),
     # Bluestein: N = 1 (M = 1), small N, and the 16 kHz and 48 kHz metric STFTs
     (1, 1, 3), (3, 2, 4), (743, 160, 4), (2229, 480, 3)],
)
def test_backward_kernel_algorithm_matches_float64(n_fft, hop, mf):
    rng = np.random.default_rng(n_fft)
    L = (mf - 1) * hop + n_fft + 3
    ext = rng.standard_normal(L).astype(np.float32)
    win = rng.uniform(0.25, 1.0, n_fft).astype(np.float32)
    g = rng.standard_normal((mf, n_fft // 2 + 1)).astype(np.float32)
    frames = np.stack([ext[f * hop : f * hop + n_fft] for f in range(mf)])
    got = _ola_np(_bwd_frames_np(frames, win, g, n_fft), L, hop)
    want = stft_magnitude_backward_plain(
        torch.from_numpy(ext).double(), torch.from_numpy(g).double(), n_fft, hop, mf, torch.from_numpy(win).double()
    )
    assert _rel(got, want.numpy()) <= EMUL_TOL


@pytest.mark.parametrize(
    "n_fft,hop,mf,seg",
    [
        # halo frames (ceil(N/hop) - 1 = 4) at two S; segments longer than the ring
        (2048, 441, 11, 3), (2048, 441, 11, 5),
        # N/hop an integer (halo 3)
        (512, 128, 9, 2), (512, 128, 9, 4),
        # Bluestein 743 and 2229 (ring of 1024 and 4096 slots)
        (743, 160, 13, 4), (743, 160, 13, 7), (2229, 480, 17, 1), (2229, 480, 17, 12),
        # hop > N: no halo, gaps between frames hold zeros
        (256, 300, 5, 2), (256, 300, 5, 3),
        # hops far below N/4 (halos of 31 and 44 frames), S = 1 and S past
        # the halo, one segment for the whole row
        (4096, 128, 45, 1), (4096, 128, 45, 33), (2229, 50, 60, 1), (2229, 50, 60, 47), (743, 160, 19, 19),
        (17, 5, 21, 4),
    ],
)
def test_segmented_overlap_add_equals_ola(n_fft, hop, mf, seg):
    """The fused kernel's segmented overlap-add is the same float32 sum as
    the plain fixed-order one, bit for bit, whatever S, halo frames
    included; samples past the last frame's end are 0."""
    P = stft_kernel._fft_plan(n_fft).fft_len
    threads = 256 if P <= 4096 else P // 16  # the kernel's block
    ring_len = 1 << (max(n_fft, threads) - 1).bit_length()
    L = (mf - 1) * hop + n_fft + 37
    d = np.random.default_rng(n_fft + seg).standard_normal((mf, n_fft)).astype(np.float32)
    got = _segmented_ola_np(d, L, hop, seg, ring_len)
    want = _ola_np(d, L, hop)
    assert np.array_equal(got, want)
    assert not got[(mf - 1) * hop + n_fft :].any()


def test_stft_function_and_backward_wrapper_on_cpu():
    """StftMagnitudeFn (the card's route) equals plain autograd on the CPU,
    where both wrappers take their plain versions and launch nothing."""
    rng = np.random.default_rng(3)
    n_fft, hop, mf = 512, 128, 9
    win = spectral.window_tensor(n_fft, n_fft, torch.device("cpu"))
    ext = torch.from_numpy(rng.standard_normal((2, (mf - 1) * hop + n_fft + 7)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((2, mf, n_fft // 2 + 1)).astype(np.float32))
    before = stft_magnitude_backward_kernel.launches
    e = ext.clone().requires_grad_(True)
    mag = StftMagnitudeFn.apply(e, n_fft, hop, mf, win)
    assert mag.grad_fn is not None
    assert torch.equal(mag, stft_magnitude_plain(ext, n_fft, hop, mf, win))
    (got,) = torch.autograd.grad(mag, e, g)
    assert torch.equal(got, stft_magnitude_backward_plain(ext, g, n_fft, hop, mf, win))
    assert torch.equal(got, stft_magnitude_backward_kernel(ext, g, n_fft, hop, mf, win))
    assert stft_magnitude_backward_kernel.launches == before
    with pytest.raises(ValueError, match="grad_mag"):
        stft_magnitude_backward_kernel(ext, g[:, 1:], n_fft, hop, mf, win)


# ----------------------------------------------------------------------
# the vocoder trainer


@pytest.fixture(scope="module")
def narrow():
    """The JAX trainer at 32 channels with its init params, and a batch of
    conditioning mels from two 0.35 s crops (35 frames)."""
    jt = j_tv.VocoderTrainer(j_voc.TFGANConfig(**NARROW))
    params = _np(jt.init_state(jax.random.PRNGKey(5))["params"])
    crops = np.stack([speechlike(0.35, 44100, seed=s) for s in (20, 21)]).astype(np.float32)
    cond = np.asarray(jt.lin_mel(jnp.asarray(crops)))
    return jt, params, cond


def test_lin_mel_matches_jax(narrow):
    jt, _, cond = narrow
    crops = np.stack([speechlike(0.35, 44100, seed=s) for s in (20, 21)]).astype(np.float32)
    got = VocoderTrainer(TFGANConfig(**NARROW), device="cpu").lin_mel(torch.from_numpy(crops))
    assert got.shape == (2, 35, 128)
    assert _rel(got, cond) <= 1e-5


def test_vocoder_loss_and_gradients_match_jax(narrow):
    jt, params, cond = narrow

    def loss_fn(p):  # VocoderTrainer.step's loss_fn
        wav = jt.model.apply({"params": p}, jnp.asarray(cond))
        out = jt.lin_mel(wav)
        T = min(out.shape[1], cond.shape[1])
        lo, hi = (2, T - 2) if T > 8 else (0, T)
        o, t = out[:, lo:hi], jnp.asarray(cond)[:, lo:hi]
        sc = jnp.linalg.norm(o - t) / (jnp.linalg.norm(t) + 1e-6)
        return sc + 0.5 * jnp.mean(jnp.abs(j_nvsr.to_log(o) - j_nvsr.to_log(t)))

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    vt = VocoderTrainer(TFGANConfig(**NARROW), device="cpu")
    state = vt.init_state(params=params)
    c = torch.from_numpy(np.array(cond))
    state, loss = vt.step(state, c, c)
    assert float(loss) == pytest.approx(float(j_loss), rel=1e-5)
    want = convert.nvsr_state_from_flax({"params": _np(j_grads)})
    got = {k: p.grad for k, p in state["model"].named_parameters()}
    assert set(got) == set(want)
    for k, g in got.items():
        w = want[k].numpy()
        assert np.abs(g.numpy() - w).max() <= GRAD_TOL * np.abs(w).max(), k


def test_fit_resumes_and_lowers_the_loss():
    audios = [speechlike(1.0, 44100, seed=s) for s in range(3)]
    vt = VocoderTrainer(TFGANConfig(**NARROW), learning_rate=2e-3, device="cpu")
    state, losses = vt.fit(audios, steps=4, batch=2, seed=3, log_every=0)
    first = [p.detach().clone() for p in state["model"].parameters()]
    state2, more = vt.fit(audios, steps=4, batch=2, seed=3, log_every=0, state=state)
    assert state2 is state and len(losses) == len(more) == 4 and np.isfinite(losses + more).all()
    assert any(not torch.equal(a, b) for a, b in zip(first, state["model"].parameters()))
    # the same crops again: the resumed model reconstructs them better
    assert more[0] < losses[0]


def test_probe_corr_matches_jax(narrow):
    jt, params, _ = narrow
    probe = probe_signal(44100)
    vt = VocoderTrainer(TFGANConfig(**NARROW), device="cpu")
    state = vt.init_state(params=params)
    assert vt.probe_corr(state["model"], probe) == pytest.approx(jt.probe_corr(params, probe), abs=1e-4)


def test_export_loads_through_both_converters(tmp_path):
    """voicefixer_state_from_vocoder -> the JAX package's converter equals
    the port's forward; the exported .pt loads back into the port's testee
    exactly."""
    vt = VocoderTrainer(SMALL_TFGAN, device="cpu")
    state = vt.init_state(seed=7)
    path = str(tmp_path / "voc.pt")
    sd = export_torch_state_dict(state["model"], SMALL_TFGAN, path)
    assert all(k.startswith("generator.") and k.endswith(("weight", "bias")) for k in sd)
    assert convert.infer_vocoder_config(sd) == SMALL_TFGAN

    jcfg = j_voc.TFGANConfig(channels=96, res_dilations=(1, 3))
    jparams, unmatched = vocoder_state_dict_to_flax(sd, jcfg, wrap_model=True)
    assert unmatched == []
    cond = np.abs(np.random.default_rng(8).standard_normal((1, 12, 128))).astype(np.float32) + 1e-3
    want = np.asarray(j_voc.Vocoder(jcfg).apply({"params": jparams}, jnp.asarray(cond)))
    with torch.no_grad():
        got = state["model"](torch.from_numpy(cond))
    assert _rel(got, want) <= 1e-4

    t = testees.NVSRTestee(model_name="dnn", device="cpu")
    assert t.load_vocoder_checkpoint(path, check=False) == []
    for k, v in state["model"].state_dict().items():
        assert torch.equal(t.model.vocoder.state_dict()[k], v), k
