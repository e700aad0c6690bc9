"""Tracing and throughput accounting.

- `StageTimers`: wall-clock accounting per pipeline stage, exposed by the
  engine as ``engine.stats`` and summarized with utterances per second and
  the decoders that ran ("native_batch", "python_pool").
- `device_trace`: a `torch.profiler` trace (CPU activities, and CUDA ones
  where a card is present) written into a directory as a Chrome/TensorBoard
  trace; enabled with ``EvalEngine(..., profile_dir=...)`` or
  ``SSR_EVAL_TPU_PROFILE=<dir>``.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict


class StageTimers:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self.utterances = 0
        self.decoders = set()
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t
            self.counts[name] += 1

    def add_utterances(self, n: int):
        self.utterances += n

    def summary(self) -> dict:
        total = time.perf_counter() - self._t0
        return {
            "total_s": round(total, 4),
            "utterances": self.utterances,
            "utterances_per_s": round(self.utterances / total, 3) if total > 0 else 0.0,
            "decoders": sorted(self.decoders),
            "stages": {
                k: {"s": round(v, 4), "calls": self.counts[k]}
                for k, v in sorted(self.seconds.items())
            },
        }


@contextlib.contextmanager
def device_trace(profile_dir: str | None):
    """A torch.profiler trace of the block into `profile_dir` (or the
    directory SSR_EVAL_TPU_PROFILE names); nothing when neither is set."""
    profile_dir = profile_dir or os.environ.get("SSR_EVAL_TPU_PROFILE")
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield
