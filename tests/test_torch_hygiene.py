"""Boundaries of the port: ssr_eval_tpu_torch never imports jax or the
JAX package, and its entry points never quietly fall back to the CPU."""

import os
import re
import subprocess
import sys

import pytest
import torch

import ssr_eval_tpu_torch
from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.testee import BatchedTestee

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ssr_eval_tpu_torch")
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|flax|ssr_eval_tpu)(\.|\s|$)", re.M)


def test_import_leaves_jax_out():
    code = (
        "import sys, ssr_eval_tpu_torch, ssr_eval_tpu_torch.test, ssr_eval_tpu_torch.models.testees\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'ssr_eval_tpu'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_no_source_imports_jax_or_the_jax_package():
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    assert len(sources) > 20
    for path in sources:
        with open(path) as f:
            hit = FORBIDDEN.search(f.read())
        assert hit is None, (path, hit and hit.group(0))


def test_no_source_runs_make_or_loads_the_jax_packages_library():
    """The port builds native/ssrio.cpp itself (io/build_native.py, into its
    own _build/): `make -C native` writes into the JAX package, and the
    library committed there is the JAX package's."""
    sources = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(PKG):
        sources += [os.path.join(d, f) for f in files if f.endswith(".py")]
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert "libssrio" not in text, path
        assert re.search(r"""["']make["']""", text) is None, path


@pytest.mark.parametrize(
    "entry",
    ["resolve_device", "engine", "helper", "test", "nvsr_testee", "leaderboard", "verify_real", "example_test",
     "example_nvsr_main", "example_train_nvsr", "make_mesh", "chip_peaks"],
)
def test_entry_points_need_a_card_unless_cpu_is_asked(entry, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from ssr_eval_tpu_torch import verify_real
    from ssr_eval_tpu_torch.examples import nvsr_main, train_nvsr
    from ssr_eval_tpu_torch.examples import test as example_test
    from ssr_eval_tpu_torch.harness.leaderboard import run_leaderboard
    from ssr_eval_tpu_torch.models.testees import NVSRTestee
    from ssr_eval_tpu_torch.models.train import make_mesh
    from ssr_eval_tpu_torch.utils.flops import chip_peaks

    monkeypatch.chdir(tmp_path)
    calls = {
        "leaderboard": lambda: run_leaderboard({"x": BatchedTestee()}, str(tmp_path), cutoffs_khz=[4]),
        "verify_real": lambda: verify_real.main(["--out", str(tmp_path / "report.json")]),
        "example_test": lambda: example_test.test(),
        "example_nvsr_main": lambda: nvsr_main.main(),
        "example_train_nvsr": lambda: train_nvsr.main(steps=1),
        "make_mesh": lambda: make_mesh(),
        "chip_peaks": lambda: chip_peaks(),
        "nvsr_testee": lambda: NVSRTestee(model_name="dnn"),
        "resolve_device": lambda: resolve_device(),
        "engine": lambda: EvalEngine([], 44100, 44100, 44100, BatchedTestee()),
        "helper": lambda: ssr_eval_tpu_torch.SSR_Eval_Helper(
            BatchedTestee(), 44100, 44100, test_data_root=str(tmp_path), auto_download=False
        ),
        "test": lambda: ssr_eval_tpu_torch.test(test_data_root=str(tmp_path), auto_download=False),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
