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


@pytest.mark.parametrize("entry", ["resolve_device", "engine", "helper", "test", "nvsr_testee"])
def test_entry_points_need_a_card_unless_cpu_is_asked(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from ssr_eval_tpu_torch.models.testees import NVSRTestee

    calls = {
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
