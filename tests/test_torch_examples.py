"""The port's examples (`ssr_eval_tpu_torch/examples/`) wire the same
configurations that tests/test_examples.py pins for the JAX package's
`examples/*.py`, and `examples.test` runs end to end on the CPU on the
synthetic VCTK set."""

import importlib.util
import os
import sys

import pytest

import ssr_eval_tpu_torch
from ssr_eval_tpu_torch.examples import nvsr_main, train_nvsr
from ssr_eval_tpu_torch.examples import test as example_test
from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk
from ssr_eval_tpu_torch.io import mp3_lame

_JAX_EXAMPLES = os.path.join(os.path.dirname(__file__), "..", "examples")


def _load_jax_example(name):
    path = os.path.abspath(os.path.join(_JAX_EXAMPLES, name + ".py"))
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


class _Capture:
    """A stand-in helper class that records the example's ctor and
    evaluate arguments."""

    def __init__(self):
        self.ctor, self.evaluate, self.testee = None, None, None
        cap = self

        class Helper:
            def __init__(self, testee, **kw):
                cap.ctor, cap.testee = dict(kw), testee

            def evaluate(self, limit_test_nums=-1, limit_test_speaker=-1):
                cap.evaluate = (limit_test_nums, limit_test_speaker)
                return {"averaged": {}}

        self.Helper = Helper


@pytest.mark.parametrize("name", ["test", "nvsr_main"])
def test_example_configuration_equals_jax(name, monkeypatch):
    """The port's example hands the helper the JAX example's keywords (and
    `device`), and the same evaluate limits."""
    port = {"test": example_test, "nvsr_main": nvsr_main}[name]
    jax_mod = _load_jax_example(name)
    caps = []
    for mod in (port, jax_mod):
        cap = _Capture()
        monkeypatch.setattr(mod, "SSR_Eval_Helper", cap.Helper)
        if name == "test":
            mod.test(**({"device": "cpu"} if mod is port else {}))
        else:
            class StubTestee:
                def __init__(self, model_name=None, ckpt=None, device=None):
                    self.args = (model_name, ckpt, device)

            mod.main(testee_cls=StubTestee, **({"device": "cpu"} if mod is port else {}))
            assert cap.testee.args[:2] == ("unet", None)
        caps.append(cap)
    got, want = caps
    assert got.ctor.pop("device") == "cpu"
    assert got.ctor == want.ctor and got.evaluate == want.evaluate
    if name == "nvsr_main":
        assert got.testee.args == ("unet", None, "cpu")


def test_example_train_nvsr_wiring(monkeypatch):
    """examples/train_nvsr.py's call surface, as tests/test_examples.py
    pins it for the JAX example (trainer stubbed)."""
    captured = {}

    class StubTrainer:
        def __init__(self, model_name=None, learning_rate=None, mesh=None, device=None):
            captured["ctor"] = (model_name, learning_rate, mesh, device)

        def fit(self, audios, **kw):
            captured["n_audios"] = len(audios)
            captured["fit"] = dict(kw)
            return None, [1.0, 0.5]

    monkeypatch.setattr(train_nvsr, "NVSRTrainer", StubTrainer)
    train_nvsr.main(steps=3, device="cpu")
    assert captured["ctor"] == ("unet", 1e-4, None, "cpu")
    assert captured["n_audios"] == 16
    fit = captured["fit"]
    assert (fit["steps"], fit["batch"], fit["crop_seconds"], fit["ckpt_every"]) == (3, 8, 1.0, 100)
    assert fit["ckpt_path"] == "./nvsr_generator_ckpt"
    train_nvsr.main(steps=1, use_mesh=True, device="cpu")
    mesh = captured["ctor"][2]
    assert mesh.shape == {"data": 1, "model": 1} and mesh.device.type == "cpu"


def test_example_test_runs_end_to_end(tmp_path, monkeypatch):
    """examples.test on the synthetic fixture: all four degradation
    families and save_processed_result through the real helper on the CPU
    (the mp3 spec is dropped where no codec is installed, as
    tests/test_examples.py does)."""
    captured = {}

    class Bounded(ssr_eval_tpu_torch.SSR_Eval_Helper):
        def __init__(self, testee, **kw):
            captured["ctor"] = dict(kw)
            if not mp3_lame.available():
                kw.pop("setting_mp3_compression", None)
            super().__init__(testee, auto_download=False, **kw)

        def evaluate(self, limit_test_nums=-1, limit_test_speaker=-1, **kw):
            captured["evaluate"] = (limit_test_nums, limit_test_speaker)
            kw.setdefault("verbose", False)
            return super().evaluate(limit_test_nums=1, limit_test_speaker=2, **kw)

    monkeypatch.chdir(tmp_path)
    ensure_synthetic_vctk("./datasets/vctk_test", files_per_speaker=2)
    monkeypatch.setattr(example_test, "SSR_Eval_Helper", Bounded)
    result = example_test.test(device="cpu")
    assert captured["evaluate"] == (10, -1)
    assert captured["ctor"]["setting_mp3_compression"] == {"low_kbps": [128]}
    keys = set(result["averaged"].keys())
    expect = {"proc_bw_24000_6_44100", "proc_subsampling_24000_44100", "proc_fft_24000_44100"}
    if mp3_lame.available():
        expect.add("proc_mp3_128_44100")
    assert expect <= keys, keys
    for k in expect:
        for m in ("lsd", "log_sispec", "sispec", "ssim"):
            assert isinstance(result["averaged"][k][m], float)
    written = [f for _, _, fs in os.walk("datasets") for f in fs if "_processed_unprocess" in f]
    assert written  # save_processed_result
