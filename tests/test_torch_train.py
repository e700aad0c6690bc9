"""The port's generator training (ssr_eval_tpu_torch.models.train and
models.data on the CPU) vs the JAX package's NVSRTrainer and
MelPairPipeline.

Sizes: the dnn and bigru generators, the UNet at widths (8, 16) with 2
blocks per group, batch 2, 16-24 frames; inputs from NumPy seeds, weights
carried by convert.nvsr_state_from_flax.  Tolerances, and why:
- losses within 1e-5 relative: one float32 mean of the same graph;
- gradients per leaf within 1e-4 of that leaf's max|JAX grad|: float32
  backward passes summed in another order (the module forwards already
  agree within 1e-4 of max, tests/test_torch_models.py).  A few leaves are
  sums that cancel: biases a BatchNorm removes (true gradient 0, both
  packages at ~1e-8 rounding noise) and the UNet's BNs on the 1-channel
  input, where the JAX package's own float32 gradient is up to 3e-2 of max
  off its float64 gradient.  A leaf outside the tolerance passes only where
  that reference error exceeds half the tolerance, and then the port must
  be no further from the JAX package's float64 gradient than the JAX
  float32 gradient is;
- BatchNorm running statistics within 1e-5 of their max: one momentum
  update of float32 batch moments;
- mel pairs within 1e-4 of max|JAX|: the degradation STFT/iSTFT and the
  |STFT| in float32 (torch.fft vs the JAX package's packed Cooley-Tukey);
- AdamW on identical gradients within 1e-6 (absolute) of optax: the same
  update rule, but optax rounds its bias corrections 1 - b^t in float32
  (1 - 0.999 is 1.3e-5 off) and torch in float64, so each step differs by
  ~6e-6 x lr;
- checkpoint round trips exact.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import flax.linen as fnn
import optax

from ssr_eval_tpu.models import data as j_data
from ssr_eval_tpu.models import nvsr as j_nvsr
from ssr_eval_tpu.models import train as j_train
from ssr_eval_tpu.models import unet as j_unet
from ssr_eval_tpu.models.checkpoint import restore_variables as j_restore
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.models import convert, nvsr, testees
from ssr_eval_tpu_torch.models.data import MelPairPipeline
from ssr_eval_tpu_torch.models.train import NVSRTrainer, adamw, make_mesh
from ssr_eval_tpu_torch.models.unet import UNetRes

GRAD_TOL = 1e-4  # of each leaf's max|JAX grad|
LOSS_RTOL = 1e-5
STATS_TOL = 1e-5  # of max|flax batch_stats leaf|
MEL_TOL = 1e-4  # of max|JAX mel|
ADAM_TOL = 1e-6  # absolute
SMALL_UNET = dict(widths=(8, 16), blocks_per_group=2)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, p))
        else:
            out[p] = np.asarray(v)
    return out


def _mels(seed, T, batch=2, n_mels=128):
    """The JAX make_batch's distribution, drawn with NumPy."""
    rng = np.random.default_rng(seed)
    lr = np.abs(rng.standard_normal((batch, T, n_mels))).astype(np.float32) + np.float32(1e-3)
    hr = lr + np.float32(0.1) * np.abs(rng.standard_normal(lr.shape)).astype(np.float32)
    return lr, hr


class _SmallUNetGenerator(fnn.Module):
    """The JAX Generator's unet branch with a small UNetRes (the JAX
    package builds its UNet generator only at full width)."""

    @fnn.compact
    def __call__(self, mel_orig, train: bool = False):
        log_mel = j_nvsr.to_log(mel_orig)
        out = j_unet.UNetRes(channels=1, name="analysis_module", **SMALL_UNET)(log_mel[..., None], train)["mel"]
        return {"mel": out[..., 0] + log_mel}


class _SmallUNetNVSR(fnn.Module):
    """NVSR's variables layout ({"generator": ...}) around it."""

    @fnn.compact
    def __call__(self, mel, train: bool = False):
        return _SmallUNetGenerator(name="generator")(mel, train)


def _jax_model(name):
    if name == "unet":
        return _SmallUNetNVSR()
    return j_nvsr.NVSR(model_name=name)


def _perturb(v, seed=3):
    """Non-trivial BN affine and running statistics, so the train-mode
    update and the batch-statistics gradients are real tests."""
    rng = np.random.default_rng(seed)
    v = _np(v)

    def walk(tree, kind):
        for sub in tree.values():
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
    walk(v["batch_stats"], "stats")
    return v


def _state64(tree):
    """nvsr_state_from_flax for a float64 tree (same layout, no cast)."""
    return {k: torch.from_numpy(np.array(v)) for k, v in convert.flax_to_port_arrays(tree).items()}


def _port_trainer(name, v):
    """The port's trainer holding `name`'s generator with the JAX
    variables `v` (the small UNet installed for 'unet')."""
    tr = NVSRTrainer(model_name="dnn" if name == "unet" else name, device="cpu")
    if name == "unet":
        with torch.device("meta"):
            gen = nvsr.Generator("unet")
        gen.analysis_module = UNetRes(channels=1, **SMALL_UNET)
        tr.model.generator = gen
    return tr, tr.init_state(params=v)


@pytest.fixture(scope="module", params=["dnn", "bigru", "unet"])
def one_step(request):
    """One training step of each generator in both packages on the same
    weights and batch: (name, JAX loss / grads / new batch_stats, port
    trainer and state after its step, port loss)."""
    name = request.param
    T = 20 if name == "unet" else 16
    jm = _jax_model(name)
    mel_lr, mel_hr = _mels(11, T)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(mel_lr), train=True)
    v = _perturb(v)
    p, bs = v["params"], v["batch_stats"]

    def loss_fn(params):  # NVSRTrainer._step's loss_fn
        out, upd = jm.apply({"params": params, "batch_stats": bs}, jnp.asarray(mel_lr), train=True,
                            mutable=["batch_stats"])
        return jnp.mean(jnp.abs(out["mel"] - j_nvsr.to_log(jnp.asarray(mel_hr)))), upd["batch_stats"]

    (j_loss, j_stats), j_grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(p)
    @functools.cache
    def truth():
        """The JAX package's float64 gradient (flax's GRU scan keeps a
        float32 carry under x64, so not for bigru)."""
        with jax.enable_x64(True):
            f64 = lambda t: jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
            bs64, lr64, hr64 = f64(bs), jnp.asarray(mel_lr, jnp.float64), jnp.asarray(mel_hr, jnp.float64)

            def loss64(params):
                out, _ = jm.apply({"params": params, "batch_stats": bs64}, lr64, train=True, mutable=["batch_stats"])
                return jnp.mean(jnp.abs(out["mel"] - j_nvsr.to_log(hr64)))

            g64 = _np(jax.jit(jax.grad(loss64))(f64(p)))
        return {k: t.double().numpy() for k, t in _state64({"params": g64}).items()}

    tr, state = _port_trainer(name, v)
    state, loss = tr.step(state, torch.from_numpy(mel_lr), torch.from_numpy(mel_hr))
    return name, float(j_loss), _np(j_grads), _np(j_stats), tr, state, float(loss), truth


def test_generator_loss_matches_jax(one_step):
    name, j_loss, _, _, _, _, loss, _ = one_step
    assert loss == pytest.approx(j_loss, rel=LOSS_RTOL), name


def test_generator_gradients_match_jax_per_leaf(one_step):
    name, _, j_grads, _, _, state, _, truth = one_step
    want = convert.nvsr_state_from_flax({"params": j_grads})
    got = {f"generator.{k}": p.grad for k, p in state["model"].named_parameters()}
    assert set(got) == set(want), set(got) ^ set(want)
    for k, g in got.items():
        w, g = want[k].numpy(), g.numpy()
        scale = np.abs(w).max()
        if np.abs(g - w).max() <= GRAD_TOL * scale:
            continue
        # the reference's own float32 rounding exceeds the tolerance here
        assert name != "bigru", (name, k, np.abs(g - w).max(), scale)
        t = truth()[k]
        ref_err = np.abs(w - t).max()
        assert ref_err > 0.5 * GRAD_TOL * scale, (name, k, np.abs(g - w).max(), ref_err, scale)
        assert np.abs(g - t).max() <= ref_err, (name, k, np.abs(g - t).max(), ref_err)


def test_batchnorm_running_stats_match_flax(one_step):
    name, _, _, j_stats, _, state, _, _ = one_step
    want = convert.nvsr_state_from_flax({"batch_stats": j_stats})
    got = state["model"].state_dict()
    keys = [k for k in want if not k.endswith("num_batches_tracked")]
    assert keys, name
    for k in keys:
        w = want[k].numpy()
        err = np.abs(got[k[len("generator."):]].numpy() - w).max()
        assert err <= STATS_TOL * np.abs(w).max(), (name, k, err)


def test_gru_hidden_rz_biases_stay_zero():
    tr = NVSRTrainer(model_name="bigru", learning_rate=1e-3, device="cpu")
    state = tr.init_state(seed=2)
    for s in range(3):
        state, loss = tr.step(state, *(torch.from_numpy(a) for a in _mels(20 + s, 16)))
        assert np.isfinite(float(loss))
    gru = state["model"].bngru.gru
    for name, p in gru.named_parameters():
        if name.startswith("bias_hh"):
            h = p.shape[0] // 3
            assert not p[: 2 * h].any(), name
            assert p[2 * h :].any(), name  # b_hn trains
    # and the trained state converts back to a flax GRUCell tree
    tree = tr.variables(state)
    assert "bias" not in tree["params"]["generator"]["bngru"]["GRUCell_0"]["hr"]


def test_adamw_matches_optax_on_identical_gradients():
    jm = j_nvsr.NVSR(model_name="dnn")
    mel_lr, _ = _mels(7, 16)
    v = _np(jm.init(jax.random.PRNGKey(4), jnp.asarray(mel_lr), train=True))
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(lambda a: rng.standard_normal(a.shape).astype(np.float32) * 1e-2, v["params"])
             for _ in range(3)]
    tx = optax.adamw(1e-3)
    params, opt = v["params"], tx.init(v["params"])
    for g in grads:
        upd, opt = tx.update(g, opt, params)
        params = optax.apply_updates(params, upd)
    want = convert.nvsr_state_from_flax({"params": _np(params)})

    gen = nvsr.Generator("dnn")
    gen.load_state_dict({k[len("generator."):]: t for k, t in convert.nvsr_state_from_flax(v).items()})
    opt_t = adamw(gen.parameters(), 1e-3)
    named = dict(gen.named_parameters())
    for g in grads:
        for k, t in convert.nvsr_state_from_flax({"params": g}).items():
            named[k[len("generator."):]].grad = t.clone()
        opt_t.step()
    for k, p in named.items():
        w = want[f"generator.{k}"].numpy()
        assert np.abs(p.detach().numpy() - w).max() <= ADAM_TOL, k


# ----------------------------------------------------------------------
# checkpoints


@pytest.mark.parametrize("name", ["dnn", "bigru"])
def test_flax_from_nvsr_state_round_trips_exactly(name):
    jm = j_nvsr.NVSR(model_name=name)
    v = _perturb(jm.init(jax.random.PRNGKey(6), jnp.ones((1, 16, 128)), train=True))
    back = convert.flax_from_nvsr_state(convert.nvsr_state_from_flax(v))
    fv, fb = _flat(v), _flat(back)
    assert set(fv) == set(fb)
    for k in fv:
        assert fb[k].dtype == np.float32 and np.array_equal(fb[k], fv[k]), k
    # and port -> flax -> port, the small UNet included
    for mod in (nvsr.Generator(name), UNetRes(channels=1, **SMALL_UNET)):
        nvsr.init_weights(mod, 8)
        sd = mod.state_dict()
        again = convert.nvsr_state_from_flax(convert.flax_from_nvsr_state(sd))
        assert set(again) == set(sd)
        for k, t in sd.items():
            assert torch.equal(again[k], t if t.is_floating_point() else torch.zeros_like(t)), k


def test_flax_from_nvsr_state_refuses_nonzero_rz_bias():
    gen = nvsr.Generator("bigru")
    sd = gen.state_dict()
    sd["bngru.gru.bias_hh_l0"] = torch.ones_like(sd["bngru.gru.bias_hh_l0"])
    with pytest.raises(ValueError, match="b_hr"):
        convert.flax_from_nvsr_state(sd)


def test_port_checkpoint_restores_in_jax_and_matches(tmp_path):
    """A checkpoint written by the port's trainer after a step, restored by
    the JAX package's restore_variables and run by NVSR.apply (eval mode),
    matches the port's eval-mode forward within 1e-4 of max."""
    jm = j_nvsr.NVSR(model_name="dnn")
    mel_lr, mel_hr = _mels(12, 16)
    v = _perturb(jm.init(jax.random.PRNGKey(3), jnp.asarray(mel_lr), train=True))
    tr, state = _port_trainer("dnn", v)
    state, _ = tr.step(state, torch.from_numpy(mel_lr), torch.from_numpy(mel_hr))
    path = tr.save(str(tmp_path / "gen"), state)
    restored = j_restore(path)
    want = jm.apply(restored, jnp.asarray(mel_hr))["mel"]
    with torch.no_grad():
        got = state["model"].eval()(torch.from_numpy(mel_hr))["mel"].numpy()
    assert np.abs(got - np.asarray(want)).max() <= 1e-4 * np.abs(np.asarray(want)).max()
    # the port's testee grafts the same file
    t = testees.NVSRTestee(model_name="dnn", device="cpu")
    t.load_generator_checkpoint(path)
    for k, p in t.model.generator.state_dict().items():
        assert torch.equal(p, state["model"].state_dict()[k]), k


# ----------------------------------------------------------------------
# the mel-pair pipeline and fit


def _audios():
    return [speechlike(0.5, 44100, seed=s) for s in range(3)] + [speechlike(0.15, 44100, seed=9)]


def test_random_crops_match_jax_bit_for_bit():
    audios = _audios()
    got = MelPairPipeline(crop_seconds=0.2, device="cpu").random_crops(audios, np.random.default_rng(4), 5)
    want = j_data.MelPairPipeline(crop_seconds=0.2).random_crops(audios, np.random.default_rng(4), 5)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("spec_idx", [0, 3])
def test_make_pair_matches_jax(spec_idx):
    audios = _audios()
    pipe = MelPairPipeline(crop_seconds=0.2, device="cpu")
    wav = pipe.random_crops(audios, np.random.default_rng(spec_idx), 2)
    lr, hr = pipe.make_pair(wav, spec_idx)
    jlr, jhr = j_data.MelPairPipeline(crop_seconds=0.2).make_pair(wav, spec_idx)
    for got, want in ((lr, jlr), (hr, jhr)):
        want = np.asarray(want)
        assert got.shape == want.shape == (2, 21, 128)
        assert np.abs(got.numpy() - want).max() <= MEL_TOL * np.abs(want).max()
    # the low-rate mel's top bands sit on the eps=1e-8 floor, the high-rate
    # mel's do not
    assert float(lr[..., -20:].sum()) < 1e-2 * float(hr[..., -20:].sum())


def test_fit_trains_and_checkpoints(tmp_path):
    tr = NVSRTrainer(model_name="dnn", learning_rate=3e-4, device="cpu")
    ckpt = str(tmp_path / "fit_ckpt")
    state, losses = tr.fit(_audios(), steps=3, batch=2, crop_seconds=0.2, ckpt_path=ckpt, ckpt_every=2,
                           log_every=0)
    assert len(losses) == 3 and np.isfinite(losses).all()
    restored = convert.nvsr_state_from_flax(j_restore(ckpt + ".npz"))
    # written after step 2: the live state moved on by one more step
    assert set(restored) == {f"generator.{k}" for k in state["model"].state_dict()}
    assert state["model"].training


def test_trainer_surface():
    tr = NVSRTrainer(model_name="dnn", device="cpu")
    a, b = tr.make_batch(3, 2, t_frames=8)
    a2, b2 = tr.make_batch(3, 2, t_frames=8)
    assert a.shape == b.shape == (2, 8, 128) and torch.equal(a, a2) and torch.equal(b, b2)
    assert bool((b >= a).all()) and float(a.min()) >= 1e-3
    # a JAX mesh is not the port's; the port's ("data", "model") mesh runs,
    # and a model axis the one-process world does not split into raises
    with pytest.raises(TypeError, match="data_mesh"):
        NVSRTrainer(model_name="dnn", mesh=j_train.make_mesh(1), device="cpu")
    with pytest.raises(ValueError, match="tp=2 does not divide"):
        make_mesh(tp=2, device="cpu")
    with pytest.raises(ValueError, match="requested 2 devices"):
        make_mesh(2, device="cpu")  # one process, no group: one rank
    mesh = make_mesh(device="cpu")
    assert (mesh.shape, mesh.rank) == ({"data": 1, "model": 1}, 0)
    tr = NVSRTrainer(model_name="dnn", mesh=mesh)
    assert tr.device == torch.device("cpu") and tr.mesh is mesh
