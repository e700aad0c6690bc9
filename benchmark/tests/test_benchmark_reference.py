"""The plain reference: its arithmetic against scipy and the float64
oracle, what it imports, and the port against it on the CPU."""

import ast
import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from scipy import signal

from benchmark import run
from benchmark.harness import cells
from benchmark.reference import dsp
from benchmark.tests.tiny import tiny_cell


@pytest.mark.parametrize("rates", [(48000, 44100), (44100, 48000), (48000, 48000)])
def test_resample_is_scipys(rates):
    x = np.random.default_rng(0).standard_normal(9001)
    a, b = rates
    g = np.gcd(a, b)
    want = signal.resample_poly(x, b // g, a // g) if a != b else x
    np.testing.assert_allclose(dsp.resample(torch.from_numpy(x), a, b).numpy(), want, atol=1e-13)


def test_stft_istft_metrics_are_the_oracles():
    from ssr_eval_tpu_torch.metrics.host_reference import istft_np, spectral_metrics_np, stft_np

    rng = np.random.default_rng(1)
    x = rng.standard_normal(20011)
    e = x + 0.1 * rng.standard_normal(len(x))
    z = stft_np(x, 2048, 441)
    np.testing.assert_allclose(dsp.stft(torch.from_numpy(x), 2048, 441).numpy(), z.T, atol=1e-10)
    np.testing.assert_allclose(dsp.istft(torch.from_numpy(z.T.copy()), 2048, 441, len(x)).numpy(),
                               istft_np(z, 2048, 441, len(x)), atol=1e-12)
    got = dsp.metrics(torch.from_numpy(e)[None], torch.from_numpy(x), 44100)
    want = spectral_metrics_np(np.abs(stft_np(e, 2048, 441)).T, np.abs(z).T)
    for k, v in want.items():
        assert float(got[k][0]) == pytest.approx(v, rel=1e-12, abs=1e-12)


def test_tf32_rounds_to_ten_mantissa_bits():
    got = dsp.tf32(torch.tensor([1 + 2**-11, 1 + 2**-10 + 2**-11, 1 + 2**-12])).tolist()
    assert got == [1.0, 1 + 2**-9, 1.0]


def test_reference_imports_nothing_of_the_program():
    allowed = {"__future__", "math", "numpy", "torch", "benchmark"}
    for path in [*(cells.BENCH / "reference").glob("*.py"), *(cells.BENCH / "degrade").glob("*.py")]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert tops <= allowed, (path.name, tops)


@pytest.mark.parametrize("name", ["noise_floor.leaderboard_sweep", "noise_floor.quickstart_jobs"])
def test_port_against_reference_on_cpu(name, one_thread):
    line = run.run_cell(name, 2**31 + 17, 0.5, False, device="cpu", cell=tiny_cell(name))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    # A CPU run reads no device time: a metric from the device trace is left out.
    assert {m for m in line["metrics"]} == {m["name"] for m in cells.load_cell(name).end_to_end
                                            if m["source"] != "device_trace"}


def test_forbidden_modules_compare_whole_names():
    assert run.forbidden_modules(["ssr_eval_tpu_torch", "ssr_eval_tpu_torch.harness", "numpy"]) == []
    assert run.forbidden_modules(["ssr_eval_tpu.io", "jax.numpy", "flax", "jaxlib", "ssr_eval"]) == [
        "flax", "jax", "jaxlib", "ssr_eval", "ssr_eval_tpu"]


def test_a_cpu_run_loads_no_jax():
    """A tiny cell end to end in a fresh process (asked for explicitly with
    device="cpu"): correct, and no forbidden module in sys.modules after."""
    code = (
        "import json, torch; torch.set_num_threads(1)\n"
        "from benchmark import run\n"
        "from benchmark.tests.tiny import tiny_cell\n"
        "n = 'noise_floor.quickstart_jobs'\n"
        "line = run.run_cell(n, 5, 0.3, True, device='cpu', cell=tiny_cell(n))\n"
        "print(json.dumps([line['correct'], run.forbidden_modules()]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, []]
