"""Tests of the port's benchmark.  Nothing here imports JAX or the JAX
package; tests that need a CUDA card carry the `cuda` marker and skip
through the `cuda_card` fixture on a machine without one."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA CUDA card; skips itself on a machine without one")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")


@pytest.fixture
def one_thread():
    """Small CPU runs on one torch thread, so they stay fast beside other
    test workers."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
