"""The port's random initialisation (`nvsr.init_weights`) against flax's
defaults, which the JAX package draws its random weights from.

flax's `Dense`, `Conv`, `ConvTranspose` and the GRU input kernels draw
`lecun_normal`: a normal truncated at +-2s, s = sqrt(1/fan_in)/0.8796, so
variance 1/fan_in and |w| <= 2.2737/sqrt(fan_in).  `GRUCell`'s recurrent
kernels `hr`, `hz`, `hn` draw `orthogonal()`, each H x H gate on its own.

Leaf by leaf (flax's tree carried to the port's names by
`convert.flax_to_port_arrays`), for the `dnn` and `bigru` generators and
the vocoder at the trained_small widths, at two seeds each (flax
`PRNGKey(s)`, the port's `init_weights(., s)`):
- every kernel: max|w| * sqrt(fan_in) <= 2/0.8796 (+1e-6), in both packages;
- leaves of >= 4096 entries: |std * sqrt(fan_in) - 1| < 0.03;
- each GRU gate block: W W^T = I within 1e-5, in both packages;
- the pooled fan-normalised kernels: two-sample KS port vs flax, p > 1e-3,
  while an untruncated N(0, 1/fan_in) draw of the same shapes gives
  p < 1e-6 against flax (the draw the port used to make);
- biases 0, BatchNorm the identity, and a seed repeats exactly.
The full-width UNet is checked on the port's side alone (bound and std):
flax's init of it takes half a minute on a CPU.
"""

import functools
import math

import numpy as np
import pytest
import torch
from scipy import stats
from torch import nn

import jax
import jax.numpy as jnp

from ssr_eval_tpu.models import nvsr as j_nvsr
from ssr_eval_tpu.models import vocoder as j_voc
from ssr_eval_tpu_torch.models import convert, nvsr, vocoder

BOUND = 2 / 0.87962566103423978 + 1e-6  # max|w| * sqrt(fan_in)
STD_TOL = 0.03  # |std * sqrt(fan_in) - 1| on leaves of >= STD_MIN entries
STD_MIN = 4096
ORTHO_TOL = 1e-5  # max|W W^T - I| per gate block
KS_SAME = 1e-3  # port vs flax: p above this
KS_BITES = 1e-6  # untruncated vs flax: p below this
SMALL_TFGAN = dict(channels=96, res_dilations=(1, 3))
MODELS = ("dnn", "bigru", "vocoder")
SEEDS = (0, 1)


def _port_model(name):
    if name == "vocoder":
        return vocoder.Vocoder(vocoder.TFGANConfig(**SMALL_TFGAN))
    return nvsr.Generator(name, 128)


@functools.lru_cache(maxsize=None)
def _flax_arrays(name, seed):
    """flax's init, carried to {port state-dict name: array}."""
    mel = jnp.ones((1, 4, 128), jnp.float32)
    if name == "vocoder":
        module = j_voc.Vocoder(j_voc.TFGANConfig(**SMALL_TFGAN))
    else:
        module = j_nvsr.Generator(model_name=name, n_mels=128)
    variables = jax.device_get(module.init(jax.random.PRNGKey(seed), mel))
    return {k: np.asarray(v, np.float64) for k, v in convert.flax_to_port_arrays(variables).items()}


@functools.lru_cache(maxsize=None)
def _port_arrays(name, seed):
    model = nvsr.init_weights(_port_model(name), seed)
    return {k: v.detach().numpy().astype(np.float64) for k, v in model.state_dict().items()}


def _layout(model):
    """({weight name: fan_in} of the LeCun-drawn kernels, [(name, H)] of the
    GRU recurrent kernels), from the layers' own attributes: flax's fan_in
    is kernel size x input channels, for a transposed conv too."""
    fans, recurrent = {}, []
    for mname, m in model.named_modules():
        pre = f"{mname}." if mname else ""
        if isinstance(m, nn.Linear):
            fans[pre + "weight"] = m.in_features
        elif isinstance(m, nn.modules.conv._ConvNd):
            assert m.groups == 1
            fans[pre + "weight"] = m.in_channels * math.prod(m.kernel_size)
        elif isinstance(m, nn.GRU):
            for pname, p in m.named_parameters():
                if pname.startswith("weight_ih"):
                    fans[pre + pname] = p.shape[1]
                elif pname.startswith("weight_hh"):
                    recurrent.append((pre + pname, m.hidden_size))
    return fans, recurrent


@functools.lru_cache(maxsize=None)
def _named_layout(name):
    return _layout(_port_model(name))


def _normalised(arrays, fans):
    return np.concatenate([arrays[k].ravel() * math.sqrt(f) for k, f in sorted(fans.items())])


def _check_kernels(arrays, fans, who):
    for k, fan in fans.items():
        w = arrays[k] * math.sqrt(fan)
        assert np.abs(w).max() <= BOUND, (who, k, np.abs(w).max())
        if w.size >= STD_MIN:
            assert abs(w.std() - 1) < STD_TOL, (who, k, w.std())


def _gate_blocks(w, hidden):
    assert w.shape == (3 * hidden, hidden)
    return [w[i * hidden : (i + 1) * hidden] for i in range(3)]


def _ortho_err(block):
    return np.abs(block @ block.T - np.eye(len(block))).max()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", MODELS)
def test_same_leaves_as_flax(name, seed):
    """The port's state dict holds flax's leaves under the same names and
    shapes, and every LeCun-drawn kernel has a fan_in."""
    port, flax = _port_arrays(name, seed), _flax_arrays(name, seed)
    assert sorted(port) == sorted(flax)
    assert all(port[k].shape == flax[k].shape for k in port)
    fans, recurrent = _named_layout(name)
    weights = {k for k in port if k.endswith("weight") or ".weight_" in k}
    bn = {k for k in weights if port[k].ndim == 1}
    assert set(fans) | {k for k, _ in recurrent} == weights - bn


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", MODELS)
def test_kernels_bounded_unit_variance(name, seed):
    fans, _ = _named_layout(name)
    _check_kernels(_port_arrays(name, seed), fans, "port")
    _check_kernels(_flax_arrays(name, seed), fans, "flax")


@pytest.mark.parametrize("seed", SEEDS)
def test_gru_gates_orthogonal(seed):
    _, recurrent = _named_layout("bigru")
    assert len(recurrent) == 4  # 2 layers x 2 directions
    for who, arrays in (("port", _port_arrays("bigru", seed)), ("flax", _flax_arrays("bigru", seed))):
        for k, hidden in recurrent:
            for i, block in enumerate(_gate_blocks(arrays[k], hidden)):
                assert _ortho_err(block) <= ORTHO_TOL, (who, k, i, _ortho_err(block))


def test_gru_gate_check_bites():
    """A stacked [3H, H] N(0, 1/H) draw (the port's old recurrent init)
    fails the gate check by far."""
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3 * 256, 256)) / 16.0
    assert min(_ortho_err(b) for b in _gate_blocks(w, 256)) > 100 * ORTHO_TOL


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", MODELS)
def test_pooled_draw_matches_flax(name, seed):
    fans, _ = _named_layout(name)
    port = _normalised(_port_arrays(name, seed), fans)
    flax = _normalised(_flax_arrays(name, seed), fans)
    assert stats.ks_2samp(port, flax).pvalue > KS_SAME


@pytest.mark.parametrize("name", MODELS)
def test_untruncated_draw_rejected(name):
    """The same KS check rejects N(0, 1/fan_in) without the truncation."""
    fans, _ = _named_layout(name)
    flax = _normalised(_flax_arrays(name, SEEDS[0]), fans)
    rng = np.random.default_rng(SEEDS[0])
    untruncated = rng.standard_normal(flax.size)
    assert stats.ks_2samp(untruncated, flax).pvalue < KS_BITES


@pytest.mark.parametrize("name", MODELS)
def test_biases_zero_batchnorm_identity(name):
    model = nvsr.init_weights(_port_model(name), SEEDS[1])
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            if "bias" in pname:
                assert not p.any(), (mname, pname)
        if isinstance(m, nn.modules.batchnorm._BatchNorm):
            assert (m.weight == 1).all() and not m.bias.any(), mname
            assert not m.running_mean.any() and (m.running_var == 1).all(), mname


@pytest.mark.parametrize("name", MODELS)
def test_seed_repeats(name):
    a = nvsr.init_weights(_port_model(name), 5).state_dict()
    b = nvsr.init_weights(_port_model(name), 5).state_dict()
    c = nvsr.init_weights(_port_model(name), 6).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a if k.endswith("weight"))


def test_full_unet_bounded_unit_variance():
    """The full-width 'unet' generator on the port's side alone."""
    model = nvsr.init_weights(nvsr.Generator("unet", 128), 2)
    fans, recurrent = _layout(model)
    assert len(fans) == 118 and not recurrent
    arrays = {k: v.numpy().astype(np.float64) for k, v in model.state_dict().items() if k in fans}
    _check_kernels(arrays, fans, "port")
