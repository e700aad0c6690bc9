"""The command as the check runs it: on a card it runs a cell and prints
its line; without one it exits 2 and prints nothing."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.harness import cells


def _run(*extra, timeout=600):
    cmd = [sys.executable, "-m", "benchmark.run", "--workload", "noise_floor.quickstart_jobs", "--seed", "7",
           "--seconds", "3", *extra]
    return subprocess.run(cmd, cwd=cells.ROOT, capture_output=True, text=True, timeout=timeout)


def test_without_a_card_it_exits_2_and_prints_nothing():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    out = _run("--trace", "0")
    assert out.returncode == 2 and out.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("trace", ["0", "1"])
def test_on_the_card(cuda_card, trace):
    out = _run("--trace", trace)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu" and line["metrics"]
