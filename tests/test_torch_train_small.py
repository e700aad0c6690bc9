"""The port's small-NVSR training recipe
(ssr_eval_tpu_torch.examples.train_small_nvsr, on the CPU) against the JAX
package's scripts/train_small_nvsr.py and its loaders.

- the training clips equal the script's exactly;
- the recipe, cut to 2 vocoder and 2 generator steps, writes artifacts that
  the JAX package reads back: `restore_variables` gives the saved tree key
  for key and leaf for leaf, in the names and shapes of the JAX dnn NVSR's
  own variables, and the JAX NVSRTestee built from the artifacts matches
  the port's testee within WAVE_TOL of max (tests/test_torch_nvsr.py's
  waveform tolerance: float32 convolutions summed in another order);
- `save_variables_npz` round-trips through the JAX `restore_variables`;
- the script refuses to write into the checked-in examples/trained_small.

Two steps do not train a vocoder that passes the load-time check, so the
recipe's assembly runs with check=False here; chip_smoke.py's train_small
phase runs the full recipe with the check on the card.
"""

import dataclasses
import hashlib
import importlib.util
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssr_eval_tpu.models import nvsr as j_nvsr
from ssr_eval_tpu.models import testees as j_testees
from ssr_eval_tpu.models.checkpoint import restore_variables as j_restore_variables
from ssr_eval_tpu.models.vocoder import TFGANConfig as JTFGANConfig
from ssr_eval_tpu_torch.examples import train_small_nvsr as tsn
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.models.checkpoint import restore_variables, save_variables, save_variables_npz

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "train_small_nvsr.py")
CHECKED_IN = os.path.join(ROOT, "examples", "trained_small")
WAVE_TOL = 1e-4  # of max|JAX|


def _leaves(tree, prefix="", leaf=np.asarray):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        out.update(_leaves(v, p, leaf) if isinstance(v, dict) else {p: leaf(v)})
    return out


def _digests(d):
    return {f: hashlib.sha256(open(os.path.join(d, f), "rb").read()).hexdigest() for f in sorted(os.listdir(d))}


def test_training_audios_equal_the_scripts():
    """Only the script's `training_audios` runs: its `main` writes into
    examples/trained_small."""
    spec = importlib.util.spec_from_file_location("_jax_train_small_nvsr", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    want = script.training_audios()
    got = tsn.training_audios()
    assert len(got) == len(want) == 48
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def recipe(tmp_path_factory):
    out = tmp_path_factory.mktemp("train_small")
    before = _digests(CHECKED_IN)
    res = tsn.train_small_nvsr(str(out), vocoder_steps=2, generator_steps=2, device="cpu", check=False,
                               log_every=0)
    assert _digests(CHECKED_IN) == before
    return out, res


def test_recipe_writes_the_scripts_artifacts(recipe):
    out, res = recipe
    assert sorted(os.listdir(out)) == ["generator_dnn.npz", "train_report.json", "vocoder_small_trained.pt"]
    rep = res["report"]
    script_keys = {"vocoder_steps", "generator_steps", "vocoder_loss_first_last", "generator_loss_first_last",
                   "vocoder_sanity"}
    assert script_keys <= set(rep)
    assert rep["vocoder_steps"] == rep["generator_steps"] == 2 and res["report"]["vocoder_steps_run"] == 2
    assert len(res["vocoder_losses"]) == len(res["generator_losses"]) == 2
    assert all(np.isfinite(res["vocoder_losses"] + res["generator_losses"]))
    assert set(rep["vocoder_sanity"]) == {"corr", "rms", "finite", "n_samples"} and rep["vocoder_sanity"]["finite"]
    assert [s for s, _ in res["probe_corr"]] == [2]


def test_jax_package_restores_the_generator_tree(recipe):
    """The .npz holds exactly the tree the trainer saved, and that tree
    has the names and shapes of the JAX dnn NVSR's own generator
    variables (what its load_generator_checkpoint grafts)."""
    _, res = recipe
    got = _leaves(j_restore_variables(res["paths"]["generator"]))
    want = _leaves(res["generator_variables"])
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    jm = j_nvsr.NVSR(model_name="dnn", vocoder_cfg=JTFGANConfig(**dataclasses.asdict(tsn.SMALL_TFGAN)))
    mel = jnp.ones((1, 16, 128), jnp.float32)
    shapes = jax.eval_shape(lambda m: jm.init(jax.random.PRNGKey(0), m, method=j_nvsr.NVSR.init_all), mel)
    ref = _leaves({c: {"generator": shapes[c]["generator"]} for c in ("params", "batch_stats")},
                  leaf=lambda a: a.shape)
    assert {k: v.shape for k, v in got.items()} == ref


def test_jax_testee_from_the_artifacts_matches_the_port(recipe):
    _, res = recipe
    jm = j_nvsr.NVSR(model_name="dnn", vocoder_cfg=JTFGANConfig(**dataclasses.asdict(tsn.SMALL_TFGAN)))
    mel = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (1, 16, 128))) + 1e-3
    v = jax.jit(lambda k, m: jm.init(k, m, method=j_nvsr.NVSR.init_all))(jax.random.PRNGKey(0), mel)
    jt = j_testees.NVSRTestee(model_name="dnn", params=v)
    jt.model = jm
    jt.load_generator_checkpoint(res["paths"]["generator"])
    assert jt.load_vocoder_checkpoint(res["paths"]["vocoder"], check=False) == []

    lens = np.asarray([8000, 5000])
    x = np.zeros((2, 8192), np.float32)
    for i, n in enumerate(lens):
        x[i, :n] = speechlike(n / 44100, 44100, seed=90 + i)[:n]
    pt = res["testee"]
    y, ny = pt.infer_batch(torch.from_numpy(x.copy()), torch.from_numpy(lens), pt.device_state())
    np.testing.assert_array_equal(ny.numpy(), lens)
    assert np.isfinite(y.numpy()).all()
    # each padded row against the JAX testee on its utterance alone ([1, n]
    # buffers, as the reference runs it; the JAX package's padded batch
    # sees the bucket's frames and trims about its length)
    f = jax.jit(jt.infer_batch)
    for i, n in enumerate(lens):
        y_j, n_j = f(jnp.asarray(x[i : i + 1, :n].copy()), jnp.asarray([n]), jt.variables)
        y_j = np.asarray(y_j)[0, :n]
        assert int(np.asarray(n_j)[0]) == n and not y[i, n:].any()
        assert np.abs(y[i, :n].numpy() - y_j).max() <= WAVE_TOL * np.abs(y_j).max()


@pytest.mark.parametrize("path", ["weights", "weights.npz"])
def test_save_variables_npz_round_trips_through_jax(tmp_path, path):
    rng = np.random.default_rng(5)
    tree = {"params": {"generator": {"dense": {"kernel": rng.standard_normal((3, 4)).astype(np.float32),
                                               "bias": torch.zeros(4)}}},
            "batch_stats": {"generator": {"bn": {"mean": rng.standard_normal(4).astype(np.float32),
                                                 "var": np.ones(4, np.float32)}}},
            "step": np.asarray(7, np.int64)}
    p = save_variables_npz(str(tmp_path / path), tree)
    assert p == str(tmp_path / "weights.npz") and os.path.exists(p)
    want = _leaves({k: v for k, v in tree.items()})
    for back in (j_restore_variables(p), restore_variables(p)):
        got = _leaves(back)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k].numpy() if isinstance(want[k], torch.Tensor) else want[k])
    # save_variables writes the same file
    q = save_variables(str(tmp_path / "again"), tree)
    with np.load(p) as a, np.load(q) as b:
        assert sorted(a.files) == sorted(b.files) and all(np.array_equal(a[k], b[k]) for k in a.files)


@pytest.mark.parametrize("how", ["absolute", "relative"])
def test_script_refuses_the_checked_in_artifacts(how, monkeypatch):
    before = _digests(CHECKED_IN)
    out = CHECKED_IN
    if how == "relative":
        monkeypatch.chdir(ROOT)
        out = os.path.join("examples", "trained_small")
    with pytest.raises(ValueError, match="refusing to write"):
        tsn.main(["2", "2", "--out", out, "--device", "cpu"])
    with pytest.raises(ValueError, match="refusing to write"):
        tsn.train_small_nvsr(out, 2, 2, device="cpu")
    assert _digests(CHECKED_IN) == before
    assert os.path.realpath(tsn.DEFAULT_OUT).startswith(os.path.realpath(os.path.join(ROOT, "ssr_eval_tpu_torch",
                                                                                      "_build")))
