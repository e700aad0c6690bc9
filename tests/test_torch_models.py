"""The port's NVSR modules (ssr_eval_tpu_torch.models, plain PyTorch on the
CPU) vs the JAX package's, on the same numpy inputs, with the JAX weights
carried across by `convert.nvsr_state_from_flax`.

Tolerances: the mel filterbank equal and the mel within 1e-6 relative;
each module's output within 1e-4 of max|JAX output| (float32 convs summed
in different orders); BN folding exact to 1e-5 of max|out| within the
port and 1e-4 of max|JAX| against the JAX package's folded model.
Small sizes throughout: UNet widths (8, 16) with 2 blocks per group, a
TFGAN vocoder at the trained_small widths (96 channels), HiFiGAN at 32.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssr_eval_tpu.models import fold_bn as j_fold
from ssr_eval_tpu.models import mel as j_mel
from ssr_eval_tpu.models import nvsr as j_nvsr
from ssr_eval_tpu.models import unet as j_unet
from ssr_eval_tpu.models import vocoder as j_voc
from ssr_eval_tpu.models.checkpoint import restore_variables as j_restore, save_variables_npz as j_save
from ssr_eval_tpu.models.testees import NVSRPaddingPostProcTestee as JPadding
from ssr_eval_tpu_torch.models import checkpoint, convert, fold_bn, mel, nvsr, unet, vocoder
from ssr_eval_tpu_torch.models.testees import NVSRPaddingPostProcTestee

MODULE_TOL = 1e-4  # of max|JAX output|
SMALL_UNET = dict(widths=(8, 16), blocks_per_group=2)
SMALL_TFGAN = dict(channels=96, res_dilations=(1, 3))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def perturb_bn(variables, seed=3):
    """Every BN gets non-trivial scale / bias / mean / var, so folding and
    the eval-mode affine are real transforms."""
    rng = np.random.default_rng(seed)
    v = _np(variables)

    def walk(tree, kind):
        for k, sub in tree.items():
            if not isinstance(sub, dict):
                continue
            if kind == "params" and "scale" in sub:
                sub["scale"] = rng.uniform(0.5, 2.0, sub["scale"].shape).astype(np.float32)
                sub["bias"] = rng.normal(0, 0.3, sub["bias"].shape).astype(np.float32)
            elif kind == "stats" and "mean" in sub:
                sub["mean"] = rng.normal(0, 0.5, sub["mean"].shape).astype(np.float32)
                sub["var"] = rng.uniform(0.3, 3.0, sub["var"].shape).astype(np.float32)
            else:
                walk(sub, kind)

    walk(v["params"], "params")
    walk(v.get("batch_stats", {}), "stats")
    return v


def port(module, variables):
    module.load_state_dict(convert.nvsr_state_from_flax(variables))
    return module.eval()


def assert_close(got, want, tol=MODULE_TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and np.abs(got - want).max() <= tol * scale, (np.abs(got - want).max(), scale)


# ----------------------------------------------------------------------
# mel


@pytest.mark.parametrize(
    "args",
    [(1025, 0.0, 22050.0, 128, 44100), (513, 0.0, 8000.0, 80, 16000, "slaney", "slaney"),
     (257, 50.0, 7000.0, 40, 16000, None, "slaney")],
)
def test_melscale_fbanks_match_jax(args):
    np.testing.assert_array_equal(mel.melscale_fbanks(*args), j_mel.melscale_fbanks(*args))


def test_mel_scale_matches_jax():
    spec = np.abs(np.random.default_rng(0).standard_normal((2, 9, 1025))).astype(np.float32)
    got = mel.MelScale()(torch.from_numpy(spec)).numpy()
    want = np.asarray(j_mel.MelScale()(jnp.asarray(spec)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())


# ----------------------------------------------------------------------
# generators


@pytest.fixture(scope="module")
def small_unet():
    net = j_unet.UNetRes(channels=1, **SMALL_UNET)
    x = jnp.zeros((1, 8, 16, 1))
    return perturb_bn(jax.jit(net.init, static_argnums=2)(jax.random.PRNGKey(0), x, False))


@pytest.mark.parametrize("T", [6, 33])
def test_unet_matches_jax(small_unet, T):
    x = np.random.default_rng(T).normal(0, 1, (2, T, 16, 1)).astype(np.float32)
    apply = jax.jit(j_unet.UNetRes(channels=1, **SMALL_UNET).apply, static_argnums=2)
    want = apply(small_unet, jnp.asarray(x), False)["mel"]
    net = port(unet.UNetRes(channels=1, **SMALL_UNET), small_unet)
    got = net(torch.from_numpy(x).permute(0, 3, 1, 2))["mel"].permute(0, 2, 3, 1)
    assert_close(got, want)


@pytest.mark.parametrize("name,n_mels", [("dnn", 128), ("bigru", 32)])
def test_generator_matches_jax(name, n_mels):
    mel_in = (np.abs(np.random.default_rng(1).standard_normal((2, 20, n_mels))) + 1e-3).astype(np.float32)
    jg = j_nvsr.Generator(model_name=name, n_mels=n_mels)
    v = perturb_bn(jax.jit(jg.init)(jax.random.PRNGKey(2), jnp.asarray(mel_in)))
    want = jax.jit(jg.apply)(v, jnp.asarray(mel_in))["mel"]
    g = port(nvsr.Generator(name, n_mels), v)
    with torch.no_grad():
        got = g(torch.from_numpy(mel_in))["mel"]
    assert_close(got, want)


# ----------------------------------------------------------------------
# vocoders


def test_tfgan_vocoder_matches_jax():
    cfg_j = j_voc.TFGANConfig(**SMALL_TFGAN)
    m = (np.abs(np.random.default_rng(3).standard_normal((2, 8, 128))) * 0.3 + 1e-4).astype(np.float32)
    jv = j_voc.Vocoder(cfg_j)
    v = _np(jax.jit(jv.init)(jax.random.PRNGKey(4), jnp.asarray(m)))
    want = jax.jit(jv.apply)(v, jnp.asarray(m))
    pv = port(vocoder.Vocoder(vocoder.TFGANConfig(**SMALL_TFGAN)), v)
    with torch.no_grad():
        got = pv(torch.from_numpy(m))
    assert got.shape == (2, 8 * 441)
    assert_close(got, want)


def test_hifigan_vocoder_matches_jax():
    """flax ConvTranspose(padding="SAME") keeps L*r samples of the full
    transposed conv from offset k-1-pad_a; held against JAX here."""
    m = np.random.default_rng(5).standard_normal((1, 8, 128)).astype(np.float32)
    jv = j_voc.HiFiGANVocoder(base_channels=32)
    v = _np(jax.jit(jv.init)(jax.random.PRNGKey(6), jnp.asarray(m)))
    want = jax.jit(jv.apply)(v, jnp.asarray(m))
    pv = port(vocoder.HiFiGANVocoder(base_channels=32), v)
    with torch.no_grad():
        got = pv(torch.from_numpy(m))
    assert got.shape == (1, 8 * 441)
    assert_close(got, want)


@pytest.mark.parametrize("k,s", [(14, 7), (6, 3), (4, 2), (3, 2), (2, 2), (5, 1)])
def test_conv_transpose_same_offset_matches_jax(k, s):
    """One transposed conv at flax 'SAME' on both sides, odd and even
    kernels, strides below and at the kernel size."""
    import flax.linen as fnn

    x = np.random.default_rng(k * 10 + s).standard_normal((1, 9, 3)).astype(np.float32)
    jc = fnn.ConvTranspose(2, (k,), strides=(s,), padding="SAME", use_bias=False)
    v = _np(jc.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = np.asarray(jc.apply(v, jnp.asarray(x)))[0].T
    tc = torch.nn.ConvTranspose1d(3, 2, k, stride=s, bias=False)
    tc.weight.data = torch.from_numpy(np.ascontiguousarray(v["params"]["kernel"][::-1].transpose(1, 2, 0)))
    off = vocoder._conv_transpose_same_offset(k, s)
    with torch.no_grad():
        got = tc(torch.from_numpy(x).transpose(1, 2))[0, :, off : off + 9 * s]
    assert_close(got, want)


def test_normalize_mel_matches_jax():
    m = np.abs(np.random.default_rng(7).standard_normal((3, 50))).astype(np.float32) ** 3
    got = vocoder.normalize_mel(torch.from_numpy(m), vocoder.TFGANConfig()).numpy()
    want = np.asarray(j_voc.normalize_mel(jnp.asarray(m), j_voc.TFGANConfig()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------------
# small pieces


def test_log_roundtrip_matches_jax():
    x = np.asarray([0.0, 1e-12, 1e-8, 0.5, 3.0, 1e6], np.float32)
    lx = nvsr.to_log(torch.from_numpy(x))
    np.testing.assert_allclose(lx.numpy(), np.asarray(j_nvsr.to_log(jnp.asarray(x))), rtol=1e-6)
    back = nvsr.from_log(lx).numpy()
    np.testing.assert_allclose(back, np.asarray(j_nvsr.from_log(j_nvsr.to_log(jnp.asarray(x)))), rtol=1e-5)
    assert back[0] == pytest.approx(1e-8) and back[-1] == pytest.approx(1e5, rel=1e-5)


def test_trim_center_matches_jax():
    """Batched and row-independent: shorter, equal and longer targets."""
    est = np.random.default_rng(8).standard_normal((4, 10)).astype(np.float32)
    ref = np.asarray([6, 10, 13, 1])
    got = nvsr.trim_center(torch.from_numpy(est), torch.from_numpy(ref)).numpy()
    want = np.asarray(jax.vmap(j_nvsr.trim_center)(jnp.asarray(est), jnp.asarray(ref)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.r_[est[0, 2:8], np.zeros(4, np.float32)])


def test_mel_tiling_matches_jax():
    rng = np.random.default_rng(9)
    m = np.zeros((3, 8, 16), np.float32)
    m[0, :, :6] = 1.0
    m[0, :, 3] = 5.0
    m[1] = np.abs(rng.standard_normal((8, 16)))
    m[2, :, :12] = np.abs(rng.standard_normal((8, 12)))
    got = NVSRPaddingPostProcTestee._tile_mel(None, torch.from_numpy(m)).numpy()
    want = np.asarray(JPadding._tile_mel(None, jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)
    assert np.all(got[0, :, -1] == got[0, 0, -1])


# ----------------------------------------------------------------------
# BatchNorm folding


def test_fold_bn_unet_exact_and_matches_jax(small_unet):
    x = np.random.default_rng(10).normal(0, 1, (2, 6, 16, 1)).astype(np.float32)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    net = port(unet.UNetRes(channels=1, **SMALL_UNET), small_unet)
    folded = unet.UNetRes(channels=1, fold_bn=True, **SMALL_UNET)
    folded.load_state_dict(fold_bn.fold_state_dict(net.state_dict(), "unet"))
    folded.eval()
    with torch.no_grad():
        ref, got = net(xt)["mel"], folded(xt)["mel"]
    assert not any("bn2" in k for k in folded.state_dict())
    assert_close(got, ref.numpy(), tol=1e-5)
    fp, fs = j_fold._fold_convblocks(small_unet["params"], small_unet["batch_stats"])
    want = j_unet.UNetRes(channels=1, fold_bn=True, **SMALL_UNET).apply(
        {"params": fp, "batch_stats": fs}, jnp.asarray(x), False
    )["mel"]
    assert_close(got.permute(0, 2, 3, 1), want)


def test_fold_bn_dnn_exact_and_matches_jax():
    mel_in = (np.abs(np.random.default_rng(11).standard_normal((1, 16, 128))) + 1e-3).astype(np.float32)
    jm = j_nvsr.NVSR(model_name="dnn", vocoder_cfg=j_voc.TFGANConfig(**SMALL_TFGAN))
    init = jax.jit(lambda k, m: jm.init(k, m, method=j_nvsr.NVSR.init_all))
    v = perturb_bn(init(jax.random.PRNGKey(12), jnp.asarray(mel_in)))
    pm = port(nvsr.NVSR("dnn", vocoder_cfg=vocoder.TFGANConfig(**SMALL_TFGAN)), v)
    pf = fold_bn.fold_nvsr_bn(pm)
    assert pf.fold_bn and not any(k.startswith("generator.bn_") for k in pf.state_dict())
    with torch.no_grad():
        ref, got = pm(torch.from_numpy(mel_in))["mel"], pf(torch.from_numpy(mel_in))["mel"]
    assert_close(got, ref.numpy(), tol=1e-5)
    jf, jfv = j_fold.fold_nvsr_bn(jm, v)
    assert_close(got, jf.apply(jfv, jnp.asarray(mel_in))["mel"])
    # the JAX package's folded tree carries straight into the folded port model
    assert_close(port(nvsr.NVSR("dnn", fold_bn=True, vocoder_cfg=vocoder.TFGANConfig(**SMALL_TFGAN)),
                      _np(jfv))(torch.from_numpy(mel_in))["mel"], ref.numpy(), tol=1e-5)


def test_fold_bn_bigru_raises():
    with pytest.raises(ValueError, match="fold_bn"):
        nvsr.NVSR("bigru", fold_bn=True)
    with pytest.raises(ValueError, match="fold_bn"):
        fold_bn.fold_nvsr_bn(nvsr.NVSR("bigru", n_mels=16))


# ----------------------------------------------------------------------
# weights carried across


def test_every_leaf_maps_and_unknown_leaves_raise(small_unet):
    state = convert.nvsr_state_from_flax(small_unet)
    n_leaves = len(jax.tree_util.tree_leaves(small_unet))
    n_bn = sum(k.endswith("running_mean") for k in state)
    assert len(state) == n_leaves + n_bn  # + one num_batches_tracked per BN
    net = unet.UNetRes(channels=1, **SMALL_UNET)
    assert set(net.state_dict()) == set(state)
    bad = {"params": {"x": {"kernel": np.zeros((3, 3, 1, 2)), "weird": np.zeros(2)}}}
    with pytest.raises(ValueError, match="unknown leaf"):
        convert.nvsr_state_from_flax(bad)
    with pytest.raises(ValueError, match="unknown collections"):
        convert.nvsr_state_from_flax({"params": {}, "cache": {}})


def test_npz_checkpoints_cross_both_packages(tmp_path, small_unet):
    """The port writes and reads the JAX package's .npz layout; Orbax
    directories raise."""
    p = checkpoint.save_variables(str(tmp_path / "a"), small_unet)
    back = j_restore(p)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(small_unet)):
        np.testing.assert_array_equal(a, b)
    q = j_save(str(tmp_path / "b"), small_unet)
    got = checkpoint.restore_variables(q[: -len(".npz")])
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(small_unet)
    (tmp_path / "orbax_dir").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        checkpoint.restore_variables(str(tmp_path / "orbax_dir"))


def test_get_n_params_matches_jax(small_unet):
    net = unet.UNetRes(channels=1, **SMALL_UNET)
    assert nvsr.get_n_params(net) == j_nvsr.get_n_params(small_unet) == nvsr.get_n_params(small_unet)
