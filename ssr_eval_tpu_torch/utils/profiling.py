"""Tracing and throughput accounting.

- `StageTimers`: the program's tracer, exposed by the engine as
  ``engine.stats``.  ``stage(name)`` is a span: it adds its host-clock
  seconds to ``seconds[name]`` and one to ``counts[name]``, always; while a
  torch profiler runs it also opens ``record_function("ssr:" + name)``, so
  the span lies on the profiler's timeline beside the device's work.  A
  child span carries its parent in a dotted name (``dispatch.degrade``
  inside ``dispatch``).  ``add(name, n)`` counts work at the same
  boundaries (``counters``); ``add_device(name, t)`` counts a 0-d integer
  tensor that the card computes, without waiting for it: the value is
  copied to the host in stream order and added by ``settle()`` (the engine
  settles at the end of every ``evaluate_files``, when the card is done).
  ``summary()`` groups each child under its parent, with utterances per
  second and the decoders that ran ("native_batch", "python_pool").
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

import torch
import torch.autograd.profiler as _autograd_profiler

SPAN_PREFIX = "ssr:"


class _Span:
    """One timed span.  With no profiler running it costs two clock reads
    and the accumulation: no `record_function` and no dispatcher call (the
    profiler's own Python flag decides)."""

    __slots__ = ("_timers", "_name", "_t", "_rf")

    def __init__(self, timers, name):
        self._timers = timers
        self._name = name

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled:
            self._rf = torch.profiler.record_function(SPAN_PREFIX + self._name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t = time.perf_counter()

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t
        self._timers.seconds[self._name] += dt
        self._timers.counts[self._name] += 1
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


class StageTimers:
    def __init__(self):
        self.seconds = defaultdict(float)
        self.counts = defaultdict(int)
        self.counters = defaultdict(int)
        self.utterances = 0
        self.decoders = set()
        self._pending = []  # add_device counts not yet read: (name, pinned host copy, event)
        self._t0 = time.perf_counter()

    def stage(self, name: str) -> _Span:
        return _Span(self, name)

    def add(self, name: str, n: int):
        self.counters[name] += n

    def add_device(self, name: str, n: torch.Tensor):
        """Count the 0-d integer tensor n; a CPU tensor counts at once."""
        if n.device.type != "cuda":
            self.add(name, int(n))
            return
        host = torch.empty((), dtype=n.dtype, pin_memory=True)
        host.copy_(n, non_blocking=True)
        done = torch.cuda.Event()
        done.record(torch.cuda.current_stream(n.device))
        self._pending.append((name, host, done))

    def settle(self):
        """Add every pending `add_device` count, waiting for the card to
        have written each."""
        for name, host, done in self._pending:
            done.synchronize()
            self.add(name, int(host))
        self._pending = []

    def add_utterances(self, n: int):
        self.utterances += n

    def summary(self) -> dict:
        total = time.perf_counter() - self._t0
        stages = {}
        for k in sorted(self.seconds):
            parent, _, child = k.partition(".")
            entry = {"s": round(self.seconds[k], 4), "calls": self.counts[k]}
            if child:
                stages.setdefault(parent, {}).setdefault("children", {})[child] = entry
            else:
                stages.setdefault(parent, {}).update(entry)
        return {
            "total_s": round(total, 4),
            "utterances": self.utterances,
            "utterances_per_s": round(self.utterances / total, 3) if total > 0 else 0.0,
            "decoders": sorted(self.decoders),
            "stages": stages,
            "counters": dict(sorted(self.counters.items())),
        }


@contextlib.contextmanager
def device_trace(profile_dir: str | None):
    """A torch.profiler trace of the block into `profile_dir` (or the
    directory SSR_EVAL_TPU_PROFILE names); nothing when neither is set."""
    profile_dir = profile_dir or os.environ.get("SSR_EVAL_TPU_PROFILE")
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    os.makedirs(profile_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir)):
        yield
