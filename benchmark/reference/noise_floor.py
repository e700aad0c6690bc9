"""The `noise_floor` testee in plain PyTorch: the degraded signal plus the
floor that the benchmark draws for the run and hands to both sides."""

from __future__ import annotations

import numpy as np
import torch


def inputs(config: dict, seed: int) -> dict:
    """{"floor": `noise_scale` * N(0, 1), `noise_samples` float32 samples}."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    return {"floor": (config["noise_scale"] * rng.standard_normal(config["noise_samples"])).astype(np.float32)}


def build(config: dict, inputs: dict, device):
    """-> testee(degraded [S, L], rnd) -> [S, L] in the input's dtype."""
    floor = torch.from_numpy(inputs["floor"].astype(np.float64)).to(device)

    def testee(d: torch.Tensor, rnd) -> torch.Tensor:
        idx = torch.arange(d.shape[-1], device=d.device) % floor.shape[0]
        return d + floor[idx].to(d.dtype)

    return testee
