"""Reading a `torch.profiler` trace of the traced jobs.

Device operations are the trace's CUDA events (kernels, copies, fills),
without the device-side copies of user annotations.  The benchmark's own
spans are CPU user annotations named "bench:<layer>"; the program's spans
(`engine.stats`, `ssr_eval_tpu_torch.utils.profiling`) are named
"ssr:<name>".  A kernel belongs to a span when the host call that launched
it (matched by correlation id) lies inside that span; the kernels of a CUDA
graph replay carry the correlation id of its `cudaGraphLaunch`.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

SPAN_PREFIX = "bench:"
PROGRAM_PREFIX = "ssr:"


class Summary(NamedTuple):
    busy_s: float                # union of device intervals
    window_s: float              # host-clock length of the traced slice
    by_name: dict                # device op name -> seconds
    span_device_s: dict          # span name -> device seconds of its kernels
    span_count: dict             # span name -> spans seen
    gaps: list                   # [(what the host was doing, seconds)], longest first
    # program span name -> {spans, host_s, device_ops, device_s, idle_s}
    # (`span_table`); None where no trace was read
    program: dict | None = None


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


def enclosing(intervals, times) -> list:
    """For each time (None: none), the indices, ascending, of the
    [start, end] intervals that hold it (ends included): one sweep over
    both sorted, not a loop over every (time, interval) pair."""
    by_start = sorted(range(len(intervals)), key=lambda i: intervals[i][0])
    out = [()] * len(times)
    active, at = [], 0
    for q in sorted((q for q in range(len(times)) if times[q] is not None), key=lambda q: times[q]):
        t = times[q]
        while at < len(by_start) and intervals[by_start[at]][0] <= t:
            active.append(by_start[at])
            at += 1
        active = [i for i in active if t <= intervals[i][1]]
        out[q] = sorted(active)
    return out


def merged(intervals) -> list:
    """Sorted, disjoint union of [start, end) pairs (touching ones joined)."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def overlap(a, b) -> float:
    """Length of the intersection of two sorted, disjoint interval lists."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def span_table(spans, device, launches) -> dict:
    """spans: [(name, start, end)]; device: [(start, end, correlation id)]
    of device ops; launches: {correlation id: host launch time}; times in
    microseconds.  -> {name: {"spans", "host_s", "device_ops", "device_s",
    "idle_s"}}: the spans of that name, their summed host seconds, the
    device ops launched inside their union and those ops' device seconds,
    and the seconds of that union in which no device op ran.  An op counts
    under every name whose spans enclose its launch (a kernel launched in
    `dispatch.testee` counts under `dispatch` too)."""
    busy = merged([(s, e) for s, e, _ in device])
    ops = sorted((launches[cid], e - s) for s, e, cid in device if cid in launches)
    at = [t for t, _ in ops]
    upto = [0.0]
    for _, d in ops:
        upto.append(upto[-1] + d)
    by_name = defaultdict(list)
    for name, s, e in spans:
        by_name[name].append((s, e))
    out = {}
    for name, ivs in by_name.items():
        union = merged(ivs)
        n_ops, dev_us = 0, 0.0
        for s, e in union:
            lo, hi = bisect.bisect_left(at, s), bisect.bisect_right(at, e)
            n_ops += hi - lo
            dev_us += upto[hi] - upto[lo]
        length = sum(e - s for s, e in union)
        out[name] = {"spans": len(ivs), "host_s": sum(e - s for s, e in ivs) / 1e6, "device_ops": n_ops,
                     "device_s": dev_us / 1e6, "idle_s": (length - overlap(union, busy)) / 1e6}
    return out


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
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith((SPAN_PREFIX, PROGRAM_PREFIX)):
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
    inside = enclosing([(s.time_range.start, s.time_range.end) for s in spans], [launch_at.get(k.id) for k in dev])
    for k, found in zip(dev, inside):
        for i in found:
            span_device_s[spans[i].name[len(SPAN_PREFIX):]] += (k.time_range.end - k.time_range.start) / 1e6
    end_us = window_s * 1e6
    gaps = sorted(idle_gaps(intervals, 0.0, end_us), key=lambda g: -g[1])[:n_gaps]
    named = [(_host_label(cpu, g0 + glen / 2), glen / 1e6) for g0, glen in gaps]
    clipped = [(max(0.0, s), min(end_us, e)) for s, e in intervals if e > 0 and s < end_us]
    program = span_table([(e.name[len(PROGRAM_PREFIX):], e.time_range.start, e.time_range.end) for e in cpu
                          if e.name.startswith(PROGRAM_PREFIX)],
                         [(k.time_range.start, k.time_range.end, k.id) for k in dev], launch_at)
    return Summary(union_seconds(clipped), window_s, dict(by_name), dict(span_device_s), dict(span_count), named,
                   program)
