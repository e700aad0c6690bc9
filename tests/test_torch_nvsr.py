"""The port's NVSR path (ssr_eval_tpu_torch.models on the CPU) vs the JAX
package: the |STFT| eps floor, NVSR.pre, the reference's UNet names,
full-width parameter carrying (shapes only), the three testees'
infer_batch and the testee surface.

Tolerances: |STFT| with eps within 1e-5 of max|JAX| and silent frames at
exactly sqrt(eps); waveforms and mels within 1e-4 of max|JAX|; bf16 vs
fp32 per-pair LSD within 0.5 (tests/test_models.py::test_bf16_inference_mode).
Sizes: the dnn and bigru generators, UNet widths (8, 16) with 2 blocks per
group, the TFGAN vocoder at the trained_small widths (96 channels);
full width appears only as shapes (jax.eval_shape, the meta device).
Small models reach a testee as the JAX package's tests give theirs one:
the testee is built at its default configuration and the small model is
installed (`_set_base`, the counterpart of assigning `testee.model`).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssr_eval_tpu.dsp.spectral import stft_magnitude as j_stft_magnitude
from ssr_eval_tpu.models import nvsr as j_nvsr
from ssr_eval_tpu.models import testees as j_testees
from ssr_eval_tpu.models import unet as j_unet
from ssr_eval_tpu.models.convert import conv_kernel, torch_state_dict_to_flax
from ssr_eval_tpu.models.vocoder import TFGANConfig as JTFGANConfig
from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.dsp.spectral import n_frames_for_length, stft_magnitude
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.io.audio import write_wav
from ssr_eval_tpu_torch.models import convert, nvsr, testees
from ssr_eval_tpu_torch.models.unet import UNetRes
from ssr_eval_tpu_torch.models.vocoder import TFGANConfig
from tests.oracles import stft_np

WAVE_TOL = 1e-4  # of max|JAX|
SMALL_TFGAN = dict(channels=96, res_dilations=(1, 3))
SMALL_UNET = dict(widths=(8, 16), blocks_per_group=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _close(got, want, tol=WAVE_TOL):
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= tol * scale, (err, scale)


def _buffers(seed=0):
    """Two rows of different lengths with silent stretches longer than a
    2048-point frame, zero-padded to one buffer."""
    a = speechlike(0.3, 44100, seed=seed)
    a[4000:9000] = 0.0
    b = np.r_[np.zeros(6000, np.float32), 0.5 * speechlike(0.15, 44100, seed=seed + 1)]
    lmax = 16384
    x = np.zeros((2, lmax), np.float32)
    x[0, : len(a)] = a
    x[1, : len(b)] = b
    return x, np.asarray([len(a), len(b)])


@pytest.fixture
def one_torch_thread():
    """Run torch's CPU ops on one intra-op thread.  With several, the CPU
    |STFT| (unfold, window product, torch.fft.rfft on MKL) has returned, on
    the first call at a batch shape in a fresh process under CPU contention,
    one thread's block of frames 1.5e-5-1.6e-4 of max off (a few percent of
    processes; also with no JAX imported; never on one thread, never on a
    repeated call): above this file's 1e-5 limits, and not the port's
    arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ----------------------------------------------------------------------
# the eps repair and NVSR.pre


def test_stft_magnitude_eps_matches_jax(one_torch_thread):
    """Each package gets its own copy of the input (torch.from_numpy and a
    zero-copy jnp.asarray would otherwise share one buffer), and each is
    also held to a float64 NumPy STFT on the valid frames, so a mismatch
    names the side that moved."""
    x, n = _buffers()
    cfg = nvsr.NVSR_STFT
    mf = cfg.max_frames(x.shape[1])
    got = stft_magnitude(torch.from_numpy(x.copy()), torch.from_numpy(n), cfg, mf, eps=1e-8)
    want = jax.vmap(lambda xi, li: j_stft_magnitude(xi, li, j_nvsr.NVSR_STFT, mf, eps=1e-8))(
        jnp.asarray(x.copy()), jnp.asarray(n)
    )
    for r in range(2):
        nf = 1 + n[r] // cfg.hop
        ref = np.sqrt(np.maximum(np.abs(stft_np(x[r, : n[r]].astype(np.float64), cfg.n_fft, cfg.hop)) ** 2, 1e-8)).T
        assert ref.shape[0] == nf
        _close(got[r, :nf], ref, tol=1e-5)
        _close(np.asarray(want)[r, :nf], ref, tol=1e-5)
    _close(got, want, tol=1e-5)
    # silent frames sit exactly on the floor; eps=0 leaves them at zero
    assert float(got.min()) == pytest.approx(1e-4, rel=1e-6)
    plain = stft_magnitude(torch.from_numpy(x), torch.from_numpy(n), cfg, mf)
    assert float(plain.min()) < 1e-6
    assert torch.equal(torch.sqrt(torch.clamp(plain * plain, min=1e-8)), got)


@pytest.fixture(scope="module")
def small_dnn():
    """The JAX package's dnn NVSR with the trained_small-width vocoder,
    random weights (the JAX init), as JAX variables."""
    jm = j_nvsr.NVSR(model_name="dnn", vocoder_cfg=JTFGANConfig(**SMALL_TFGAN))
    mel = jnp.abs(jax.random.normal(jax.random.PRNGKey(7), (1, 16, 128))) + 1e-3
    v = jax.jit(lambda k, m: jm.init(k, m, method=j_nvsr.NVSR.init_all))(jax.random.PRNGKey(3), mel)
    return jm, _np(v)


def test_nvsr_pre_matches_jax(small_dnn):
    jm, v = small_dnn
    x, n = _buffers(3)
    mf = nvsr.NVSR_STFT.max_frames(x.shape[1])
    pm = nvsr.NVSR("dnn", vocoder_cfg=TFGANConfig(**SMALL_TFGAN)).eval()
    sp, mel = pm.pre(torch.from_numpy(x), torch.from_numpy(n), mf)
    for j in range(2):
        jsp, jmel = jm.apply(v, jnp.asarray(x[j]), int(n[j]), mf, method=j_nvsr.NVSR.pre)
        _close(sp[j], jsp, tol=1e-5)
        _close(mel[j], jmel, tol=1e-5)


# ----------------------------------------------------------------------
# the reference's UNet names


def test_unet_state_dict_carries_reference_names():
    """The names and shapes pinned by tests/test_convert.py:92-108."""
    with torch.device("meta"):
        sd = nvsr.NVSR("unet").state_dict()
    pre = "generator.analysis_module.encoder_block1.conv_block1."
    assert tuple(sd[pre + "conv1.weight"].shape) == (32, 1, 3, 3)
    assert tuple(sd[pre + "shortcut.weight"].shape) == (32, 1, 1, 1)
    assert tuple(sd[pre + "shortcut.bias"].shape) == (32,)
    for k in ("weight", "bias", "running_mean", "running_var"):
        assert tuple(sd[pre + f"bn1.{k}"].shape) == (1,)
    for k in ("encoder_block6.conv_block4.bn2.weight", "conv_block7.conv2.weight",
              "decoder_block1.conv1.weight", "decoder_block6.conv_block5.conv1.weight",
              "after_conv_block1.conv1.weight", "after_conv2.weight", "after_conv2.bias"):
        assert "generator.analysis_module." + k in sd, k
    # the decoder's transposed conv keeps torch's (in, out, kh, kw)
    assert tuple(sd["generator.analysis_module.decoder_block1.conv1.weight"].shape) == (384, 384, 3, 3)
    assert tuple(sd["generator.analysis_module.decoder_block6.conv1.weight"].shape) == (64, 32, 3, 3)


def test_reference_state_dict_loads_directly_and_matches_jax():
    """A reference-named state dict loads into the port with no conversion
    and its forward pass equals the JAX UNet carrying the same weights.
    The JAX oracle takes torch_state_dict_to_flax for every leaf except the
    decoders' residual-block conv1s, which that converter maps as
    transposed convs (wrong shape or flipped values): those take the
    plain-conv rule `conv_kernel`."""
    src = nvsr.UNetRes(channels=1, **SMALL_UNET)
    nvsr.init_weights(src, seed=5)
    g = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for m in src.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.weight.uniform_(0.5, 2.0, generator=g)
                m.bias.normal_(0, 0.3, generator=g)
                m.running_mean.normal_(0, 0.5, generator=g)
                m.running_var.uniform_(0.3, 3.0, generator=g)
    ref_sd = {"generator.analysis_module." + k: v.clone() for k, v in src.state_dict().items()}

    port = nvsr.UNetRes(channels=1, **SMALL_UNET)
    port.load_state_dict({k[len("generator.analysis_module."):]: v for k, v in ref_sd.items()})
    port.eval()

    variables, unmatched = torch_state_dict_to_flax(ref_sd)
    assert unmatched == []
    am = variables["params"]["generator"]["analysis_module"]
    # the JAX converter's fault: a residual conv1 under a decoder_block
    # comes out as a transposed-conv kernel (3, 3, out, in)
    assert am["decoder_block1"]["conv_block2"]["conv1"]["kernel"].shape == (3, 3, 16, 32)
    for k, w in ref_sd.items():
        parts = k.split(".")
        if "decoder_block" in k and parts[-3].startswith("conv_block") and parts[-2] == "conv1":
            node = am
            for p in parts[2:-1]:
                node = node[p]
            node["kernel"] = conv_kernel(w)
    jv = {"params": am, "batch_stats": variables["batch_stats"]["generator"]["analysis_module"]}

    x = np.random.default_rng(4).normal(0, 1, (2, 9, 16, 1)).astype(np.float32)
    want = j_unet.UNetRes(channels=1, **SMALL_UNET).apply(jv, jnp.asarray(x), False)["mel"]
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2))["mel"].permute(0, 2, 3, 1)
    _close(got, want)


# ----------------------------------------------------------------------
# full width, shapes only


def test_full_width_parameters_carry_every_leaf():
    """jax.eval_shape of the JAX package's full-width init (65M UNet +
    default TFGAN vocoder) maps onto every entry of the port's state dict
    with the port's shapes; nothing is compiled or allocated at full
    width (zero-stride placeholders, the meta device)."""
    jm = j_nvsr.NVSR(model_name="unet")
    shapes = jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.ones((1, 64, 128)), method=j_nvsr.NVSR.init_all)
    )

    def placeholders(t):
        if isinstance(t, dict) or hasattr(t, "items"):
            return {k: placeholders(v) for k, v in t.items()}
        return np.broadcast_to(np.zeros((), t.dtype), t.shape)

    tree = placeholders(shapes)
    arrays = convert.flax_to_port_arrays(tree)
    with torch.device("meta"):
        pm = nvsr.NVSR("unet")
    sd = pm.state_dict()
    assert set(arrays) == set(sd)
    for k, v in sd.items():
        assert tuple(arrays[k].shape) == tuple(v.shape), k
    n_unet = nvsr.get_n_params(pm.generator)
    assert 5.5e7 < n_unet < 7.5e7, n_unet
    assert n_unet == j_nvsr.get_n_params(tree["params"]["generator"])


# ----------------------------------------------------------------------
# the testees


def _small_nvsr(name, v=None, seed=0):
    """An unfolded NVSR with the trained_small-width vocoder, carrying the
    JAX variables `v`, else seeded random weights.  'unet' is the UNet
    generator at SMALL_UNET widths (the Generator is built on the meta
    device, then its analysis module is replaced)."""
    base = nvsr.NVSR("dnn" if name == "unet" else name, vocoder_cfg=TFGANConfig(**SMALL_TFGAN))
    if name == "unet":
        with torch.device("meta"):
            base.generator = nvsr.Generator("unet")
        base.generator.analysis_module = UNetRes(channels=1, **SMALL_UNET)
    if v is not None:
        base.load_state_dict(convert.nvsr_state_from_flax(v))
    else:
        nvsr.init_weights(base, seed)
    return base


def _install(cls, base, **kw):
    t = cls(model_name="dnn", device="cpu", **kw)
    t._set_base(base)
    return t


def _port_testee(cls, v, **kw):
    return _install(cls, _small_nvsr("dnn", v), **kw)


def _jax_alone(jt, x, n, state):
    """The JAX testee on each utterance alone, in a [1, n_j] buffer (as the
    reference runs it): [(row j's output, its length)].  On a padded batch
    the JAX package's testees see the bucket's frames and trim about the
    bucket's length, so its batch is not the expectation."""
    f = jax.jit(jt.infer_batch)
    out = []
    for j, k in enumerate(n):
        y, ny = f(jnp.asarray(x[j : j + 1, :k]), jnp.asarray([k]), state)
        out.append((np.asarray(y)[0], int(np.asarray(ny)[0])))
    return out


def _close_rows(y, ny, want):
    """Each row of the port's padded batch against its utterance alone,
    over every sample, and zero past its length."""
    for j, (w, k) in enumerate(want):
        assert int(ny[j]) == k
        _close(y[j, :k], w[:k])
        assert not y[j, k:].any()


@pytest.mark.parametrize("name", ["NVSRTestee", "NVSRPostProcTestee", "NVSRPaddingPostProcTestee"])
def test_testee_infer_batch_matches_jax(small_dnn, name):
    jm, v = small_dnn
    jt = getattr(j_testees, name)(model_name="dnn", params=v)
    jt.model = jm
    x, n = _buffers(9)
    want = _jax_alone(jt, x, n, jt.variables)
    pt = _port_testee(getattr(testees, name), v)
    y, ny = pt.infer_batch(torch.from_numpy(x), torch.from_numpy(n), pt.device_state())
    _close_rows(y, ny, want)


def test_bigru_testee_matches_jax():
    jm = j_nvsr.NVSR(model_name="bigru", vocoder_cfg=JTFGANConfig(**SMALL_TFGAN))
    mel = jnp.abs(jax.random.normal(jax.random.PRNGKey(8), (1, 16, 128))) + 1e-3
    v = _np(jax.jit(lambda k, m: jm.init(k, m, method=j_nvsr.NVSR.init_all))(jax.random.PRNGKey(2), mel))
    jt = j_testees.NVSRTestee(model_name="bigru", params=v)
    jt.model = jm
    x, n = _buffers(11)
    want = _jax_alone(jt, x, n, jt.variables)
    pt = _install(testees.NVSRTestee, _small_nvsr("bigru", v))
    y, ny = pt.infer_batch(torch.from_numpy(x), torch.from_numpy(n))
    _close_rows(y, ny, want)


def test_small_unet_testee_runs():
    """The UNet generator through the testee at small widths equals the
    model's own pre -> generator -> synthesize -> trim_center given each
    row's frames, exactly (the JAX package cannot build its UNet NVSR at
    small widths; the UNet itself is held against JAX in
    tests/test_torch_models.py, each padded row against its utterance alone
    in tests/test_torch_nvsr_lengths.py)."""
    base = _small_nvsr("unet", seed=3)
    x, n = _buffers(12)
    xt, nt = torch.from_numpy(x), torch.from_numpy(n)
    y, _ = _install(testees.NVSRTestee, base).infer_batch(xt, nt)
    with torch.no_grad():
        _, mel = base.eval().pre(xt, nt, nvsr.NVSR_STFT.max_frames(x.shape[1]))
        frames = n_frames_for_length(nvsr.NVSR_STFT, nt)
        mel = mel * (torch.arange(mel.shape[1])[None, :] < frames[:, None])[:, :, None]
        want = nvsr.trim_center(base.synthesize(base(mel, frames)["mel"], frames), nt, frames * 441)
    assert y.shape == (2, (1 + x.shape[1] // 441) * 441)
    assert torch.isfinite(y).all() and torch.equal(y, want)


def test_param_dtype_matches_jax(small_dnn):
    """param_dtype=bfloat16 rounds every parameter, BatchNorm's scale and
    bias included, as the JAX package rounds its `params`; outputs within
    1e-4 of max|JAX| (the BNs given non-trivial scale and bias first)."""
    jm, v = small_dnn
    v = {"params": jax.tree_util.tree_map(np.copy, v["params"]), "batch_stats": v["batch_stats"]}
    rng = np.random.default_rng(15)
    for i in range(3):
        v["params"]["generator"][f"bn_{i}"] = {
            "scale": rng.uniform(0.5, 2.0, (1,)).astype(np.float32),
            "bias": rng.normal(0, 0.3, (1,)).astype(np.float32),
        }
    jt = j_testees.NVSRTestee(model_name="dnn", params=v, param_dtype=jnp.bfloat16)
    jt.model = jm
    x, n = _buffers(16)
    want = _jax_alone(jt, x, n, jt.device_state())
    pt = _port_testee(testees.NVSRTestee, v, param_dtype=torch.bfloat16)
    y, ny = pt.infer_batch(torch.from_numpy(x), torch.from_numpy(n))
    _close_rows(y, ny, want)
    y32, _ = _port_testee(testees.NVSRTestee, v).infer_batch(torch.from_numpy(x), torch.from_numpy(n))
    assert not torch.equal(y, y32)


def test_fold_bn_testee_wiring(small_dnn):
    _, v = small_dnn
    x, n = _buffers(13)
    y0, _ = _port_testee(testees.NVSRTestee, v).infer_batch(torch.from_numpy(x), torch.from_numpy(n))
    y1, _ = _port_testee(testees.NVSRTestee, v, fold_bn=True).infer_batch(torch.from_numpy(x), torch.from_numpy(n))
    _close(y1, y0.numpy(), tol=1e-5)
    with pytest.raises(ValueError, match="fold_bn"):
        testees.NVSRTestee(model_name="bigru", fold_bn=True, device="cpu")


def test_infer_batch_keeps_no_autograd_graph(small_dnn):
    """The engine calls infer_batch outside any no_grad: the testee's own
    inference_mode must leave no graph behind."""
    _, v = small_dnn
    t = _port_testee(testees.NVSRPostProcTestee, v)
    assert all(p.requires_grad for p in t.model.parameters())
    x, n = _buffers(14)
    y, ny = t.infer_batch(torch.from_numpy(x), torch.from_numpy(n))
    assert y.grad_fn is None and not y.requires_grad and torch.is_inference(y)


def test_device_state_is_one_cached_object(small_dnn):
    _, v = small_dnn
    t = _port_testee(testees.NVSRTestee, v, param_dtype=torch.bfloat16)
    s = t.device_state()
    assert t.device_state() is s and set(s) == {"generator", "vocoder"}
    # rounded to bfloat16, computed in float32 (dtype None); BatchNorm's
    # affine rounded too, its running statistics not
    for k in ("dense_0.weight", "bn_0.weight"):
        w = s["generator"][k]
        assert w.dtype == torch.float32 and torch.equal(w, w.to(torch.bfloat16).to(torch.float32)), k
    var = s["generator"]["bn_0.running_var"]
    assert var.dtype == torch.float32 and torch.equal(var, t.model.generator.bn_0.running_var)


def test_bf16_testee_close_to_fp32(tmp_path):
    """dtype=bfloat16: the model under a bf16 autocast, the DSP float32;
    per-pair LSD within 0.5 of the float32 run (the JAX package's bound)."""
    p = str(tmp_path / "u.wav")
    write_wav(p, speechlike(0.3, 44100, seed=60), 44100)
    specs = expand_settings(setting_fft={"cutoff_freq": [8000]}, sr=44100)
    r = {}
    for dt in (None, torch.bfloat16):
        t = _install(testees.NVSRTestee, _small_nvsr("dnn", seed=5), dtype=dt)
        r[dt] = EvalEngine(specs, 44100, 44100, 44100, t, batch_size=1, device="cpu").evaluate_files([p])[p]
    a, b = r[None]["proc_fft_8000_44100"]["lsd"], r[torch.bfloat16]["proc_fft_8000_44100"]["lsd"]
    assert np.isfinite(b) and abs(a - b) < 0.5 and a != b, (a, b)


def test_load_checkpoint_reference_layout(tmp_path):
    """A lightning-style {"state_dict": ...} with reference names loads into
    the generator; entries outside it are reported; a missing one raises."""
    kw = dict(model_name="dnn", device="cpu")
    src = testees.NVSRTestee(seed=21, **kw)
    sd = {f"generator.{k}": v for k, v in src.model.generator.state_dict().items()}
    sd["vocoder.extra.weight"] = torch.zeros(3)
    path = str(tmp_path / "nvsr.ckpt")
    torch.save({"state_dict": sd}, path)
    t = testees.NVSRTestee(seed=22, ckpt=path, **kw)
    for k, v in src.model.generator.state_dict().items():
        assert torch.equal(t.model.generator.state_dict()[k], v), k
    assert t.load_checkpoint(path) == ["vocoder.extra.weight"]
    del sd["generator.dense_4.bias"]
    torch.save({"state_dict": sd}, path)
    with pytest.raises(ValueError, match="lacks 1 generator entries"):
        testees.NVSRTestee(seed=22, ckpt=path, **kw)


def test_download_checkpoint_never_downloads(tmp_path):
    with pytest.raises(RuntimeError, match="does not download"):
        testees.download_checkpoint(str(tmp_path))
    cached = tmp_path / "epoch=11-step=22499-val_l=0.27.pth"
    cached.write_bytes(b"")
    assert testees.download_checkpoint(str(tmp_path)) == str(cached)
    assert testees.NVSRBaseTestee is testees.NVSRTestee
    assert os.path.basename(testees.CKPT_URL) == os.path.basename(j_testees.CKPT_URL)


# ----------------------------------------------------------------------
# the trained_small chain (examples/trained_small: a dnn generator and a
# small TFGAN vocoder trained by the JAX package's scripts)

ART = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "trained_small")
GEN = os.path.join(ART, "generator_dnn.npz")
VOC = os.path.join(ART, "vocoder_small_trained.pt")
TRAINED_CUTOFFS = [2000, 4000, 6000]  # the helper doubles them: tests/test_trained_small.py's 4-12 kHz
# tests/test_torch_harness.py's PARITY, but LSD 5e-4: the spliced trained
# output is less well conditioned than that file's noisy testee.  The two
# packages' waveforms agree within 8e-6 of max, and that difference alone,
# scored by one metric implementation, moves a pair's LSD by up to 2.9e-4
# (the 2 kHz cutoff); the largest port-vs-JAX pair measured is 1.34e-4.
PARITY = {"lsd": 5e-4, "log_sispec": 5e-4, "sispec": 1e-4, "ssim": 5e-6}


def _trained(cls):
    t = cls(model_name="dnn", device="cpu")
    t.load_generator_checkpoint(GEN)
    assert t.load_vocoder_checkpoint(VOC, check=True) == []
    return t


def test_trained_vocoder_passes_and_random_trips_the_check(tmp_path):
    from ssr_eval_tpu_torch.models.vocoder_check import VocoderSanityError, check_vocoder, synthesis_report

    t = _trained(testees.NVSRTestee)
    assert t.model.vocoder.cfg == TFGANConfig(channels=96, res_dilations=(1, 3))
    rep = synthesis_report(t.model)
    assert rep["finite"] and rep["rms"] > 1e-4 and rep["corr"] > 0.5, rep
    rnd_model = nvsr.init_weights(nvsr.NVSR("dnn", vocoder_cfg=t.model.vocoder.cfg), seed=1).eval()
    with pytest.raises(VocoderSanityError):
        check_vocoder(rnd_model)
    # a random mirror of the checkpoint's layout loads, and trips the check
    sd = torch.load(VOC, map_location="cpu", weights_only=False)
    g = torch.Generator().manual_seed(0)
    rnd = {k: torch.randn(v.shape, generator=g) * 0.1 for k, v in sd.items()}
    path = str(tmp_path / "random_vocoder.pt")
    torch.save(rnd, path)
    assert t.load_vocoder_checkpoint(path, check=False) == []
    with pytest.raises(VocoderSanityError):
        t.load_vocoder_checkpoint(path, check=True)


@pytest.fixture(scope="module")
def trained_sweep(tmp_path_factory):
    """The trained NVSRPostProcTestee's fft sweep through the port's helper
    and the JAX engine, and the identity testee's through the port's.  The
    JAX engine runs every file in a buffer of its own length (its
    `bucket_length` patched to the identity), as the reference runs each
    utterance: on a padded bucket the JAX package's testees see the
    bucket's frames and trim about its length."""
    import ssr_eval_tpu_torch
    from ssr_eval_tpu.degrade.plan import expand_settings as j_expand
    from ssr_eval_tpu.harness.engine import EvalEngine as JEngine

    root = tmp_path_factory.mktemp("trained_small") / "data"
    paths = []
    for i in range(2):
        os.makedirs(root / "p000", exist_ok=True)
        p = str(root / "p000" / f"u{i}.wav")
        write_wav(p, speechlike(0.5, 44100, seed=70 + i), 44100)
        paths.append(p)

    jm = j_nvsr.NVSR(model_name="dnn", vocoder_cfg=JTFGANConfig(**SMALL_TFGAN))
    mel = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (1, 16, 128))) + 1e-3
    v = jax.jit(lambda k, m: jm.init(k, m, method=j_nvsr.NVSR.init_all))(jax.random.PRNGKey(0), mel)
    jt = j_testees.NVSRPostProcTestee(model_name="dnn", params=v)
    jt.model = jm
    jt.load_generator_checkpoint(GEN)
    assert jt.load_vocoder_checkpoint(VOC, check=False) == []
    specs = j_expand(setting_fft={"cutoff_freq": [2 * c for c in TRAINED_CUTOFFS]}, sr=44100)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr("ssr_eval_tpu.harness.engine.bucket_length", lambda n: n)
        want = JEngine(specs, 44100, 44100, 44100, jt, batch_size=2).evaluate_files(paths)

    cwd = os.getcwd()
    os.chdir(tmp_path_factory.mktemp("trained_small_run"))
    try:
        kw = dict(input_sr=44100, output_sr=44100, evaluation_sr=44100, test_data_root=str(root),
                  setting_fft={"cutoff_freq": TRAINED_CUTOFFS}, auto_download=False, batch_size=2, device="cpu")
        got = ssr_eval_tpu_torch.SSR_Eval_Helper(
            _trained(testees.NVSRPostProcTestee), test_name="trained", **kw).evaluate(verbose=False)
        ident = ssr_eval_tpu_torch.SSR_Eval_Helper(
            ssr_eval_tpu_torch.BatchedTestee(), test_name="identity", **kw).evaluate(verbose=False)
    finally:
        os.chdir(cwd)
    return paths, want, got, ident


def test_trained_small_sweep_matches_jax(trained_sweep):
    paths, want, got, _ = trained_sweep
    n = 0
    for p in paths:
        for key, m in want[p].items():
            for k, tol in PARITY.items():
                a = got["p000"][os.path.basename(p)][key][k]
                assert abs(a - m[k]) <= tol, (p, key, k, a, m[k])
            n += 1
    assert n == 2 * len(TRAINED_CUTOFFS)


def test_trained_small_beats_identity(trained_sweep):
    _, _, got, ident = trained_sweep
    assert list(got["averaged"]) == list(ident["averaged"]) and len(got["averaged"]) == len(TRAINED_CUTOFFS)
    for key, m in ident["averaged"].items():
        assert got["averaged"][key]["lsd"] < m["lsd"], (key, got["averaged"][key], m)
