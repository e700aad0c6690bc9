"""Reading a `torch.profiler` trace of the traced jobs.

Device operations are the trace's CUDA events (kernels, copies, fills),
without the device-side copies of user annotations.  The benchmark's own
spans are CPU user annotations named "bench:<layer>"; a kernel belongs to a
span when the host call that launched it (matched by correlation id) lies
inside that span.
"""

from __future__ import annotations

from collections import defaultdict
from typing import NamedTuple

SPAN_PREFIX = "bench:"


class Summary(NamedTuple):
    busy_s: float                # union of device intervals
    window_s: float              # host-clock length of the traced slice
    by_name: dict                # device op name -> seconds
    span_device_s: dict          # span name -> device seconds of its kernels
    span_count: dict             # span name -> spans seen
    gaps: list                   # [(what the host was doing, seconds)], longest first


def _is_device(e) -> bool:
    return getattr(e.device_type, "name", str(e.device_type)).upper().endswith("CUDA")


def union_seconds(intervals) -> float:
    """Total length (seconds) of the union of [start, end) microsecond pairs."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e6


def idle_gaps(intervals, start: float, end: float):
    """[(gap start, gap length)] in microseconds between device intervals
    within [start, end]."""
    gaps, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, s - at))
        at = max(at, e)
    if end > at:
        gaps.append((at, end - at))
    return gaps


def _host_label(cpu, t: float) -> str:
    """The innermost host op or span running at time t (microseconds)."""
    running = [e for e in cpu if e.time_range.start <= t <= e.time_range.end]
    if not running:
        return "host: no op (python, decode, helper)"
    return max(running, key=lambda e: e.time_range.start).name


def summarize(events, window_s: float, n_gaps: int = 10) -> Summary:
    """events: the profiler's FunctionEvents over a slice that began at the
    profiler's start and lasted window_s seconds on the host clock."""
    dev, cpu = [], []
    for e in events:
        if _is_device(e):
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith(SPAN_PREFIX):
                dev.append(e)
        else:
            cpu.append(e)
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6

    spans = [e for e in cpu if e.name.startswith(SPAN_PREFIX)]
    span_count = defaultdict(int)
    for s in spans:
        span_count[s.name[len(SPAN_PREFIX):]] += 1
    launch_at = {}
    for e in cpu:
        if e.name.startswith("cu") and e.id:
            launch_at[e.id] = e.time_range.start
    span_device_s = defaultdict(float)
    for k in dev:
        t = launch_at.get(k.id)
        if t is None:
            continue
        for s in spans:
            if s.time_range.start <= t <= s.time_range.end:
                span_device_s[s.name[len(SPAN_PREFIX):]] += (k.time_range.end - k.time_range.start) / 1e6
    end_us = window_s * 1e6
    gaps = sorted(idle_gaps(intervals, 0.0, end_us), key=lambda g: -g[1])[:n_gaps]
    named = [(_host_label(cpu, g0 + glen / 2), glen / 1e6) for g0, glen in gaps]
    clipped = [(max(0.0, s), min(end_us, e)) for s, e in intervals if e > 0 and s < end_us]
    return Summary(union_seconds(clipped), window_s, dict(by_name), dict(span_device_s), dict(span_count), named)
