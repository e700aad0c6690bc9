"""The `noise_floor` testee: adds a fixed broadband floor to its input on
the device (a frozen copy of the port benchmark program's `NoisyTestee`),
so every band of the estimate sits far above float32 rounding and the
comparison with the float64 reference measures the pipeline, not the
rounding floor of masked bands.  The floor is the one the benchmark drew
for the run (`reference/noise_floor.py::inputs`)."""

from __future__ import annotations

import torch

from ssr_eval_tpu_torch.harness.testee import BatchedTestee


class NoisyTestee(BatchedTestee):
    """Adds the floor (its device state) to the valid samples of its input."""

    def __init__(self, floor):
        self.floor = floor

    def device_state(self):
        return self.floor

    def infer_batch(self, x, lengths, state=None):
        ar = torch.arange(x.shape[1], device=x.device)
        mask = (ar[None, :] < lengths[:, None]).to(torch.float32)
        return x.to(torch.float32) + state[ar % state.shape[0]][None, :] * mask, lengths


def build(config: dict, inputs: dict, device, workdir: str):
    return NoisyTestee(inputs["floor"])
