"""The trace summary's table of the program's `ssr:` spans, on profiler
events built by hand, and the summary's other fields against a frozen copy
of the function that computed them before the table was added."""

from collections import defaultdict
from types import SimpleNamespace

import pytest

from benchmark.harness import trace

CPU, CUDA = SimpleNamespace(name="CPU"), SimpleNamespace(name="CUDA")
US = 1e-6


def _event(name, start, end, device=CPU, id=0, annotation=False):
    return SimpleNamespace(name=name, device_type=device, time_range=SimpleNamespace(start=start, end=end), id=id,
                           is_user_annotation=annotation)


# Times in microseconds from the profiler's start; a window of 1000.
HOST = [
    ("ssr:job", 0, 900),
    ("ssr:decode", 10, 200), ("bench:decode", 10, 200), ("ssr:decode.native", 20, 150),
    ("ssr:dispatch", 200, 400), ("bench:dispatch", 200, 400),
    ("ssr:dispatch.prep", 205, 240), ("ssr:dispatch.replay", 245, 260),
    ("ssr:dispatch.testee", 262, 300), ("bench:testee", 262, 300),
    ("ssr:decode", 400, 600), ("ssr:drain", 600, 700), ("aten::copy_", 610, 620),
]
LAUNCHES = [("cudaLaunchKernel", 30, 32, 1), ("cudaMemcpyAsync", 210, 212, 2), ("cudaGraphLaunch", 250, 255, 3),
            ("cudaLaunchKernel", 270, 272, 4)]
# Op 3's two kernels are one graph replay's; the device idles from 60 to
# 215 (inside the first decode) and from 420 on (the second decode, the
# drain).
DEVICE = [("fill", 40, 60, 1), ("Memcpy HtoD", 215, 230, 2), ("graph_kernel_a", 256, 300, 3),
          ("graph_kernel_b", 300, 330, 3), ("testee_kernel", 330, 420, 4)]


def _events():
    out = [_event(n, s, e) for n, s, e in HOST]
    out += [_event(n, s, e, id=i) for n, s, e, i in LAUNCHES]
    out += [_event(n, s, e, CUDA, i) for n, s, e, i in DEVICE]
    # The device-side copy of a program span: an annotation, not an op.
    out.append(_event("ssr:dispatch", 205, 400, CUDA, annotation=True))
    return out


# name -> (spans, host us, device ops, device us, idle us)
WANT = {
    "job": (1, 900, 5, 199, 900 - 199),
    "decode": (2, 390, 1, 20, 390 - 40),
    "decode.native": (1, 130, 1, 20, 110),
    "dispatch": (1, 200, 4, 179, 200 - 159),
    "dispatch.prep": (1, 35, 1, 15, 20),
    "dispatch.replay": (1, 15, 2, 74, 11),
    "dispatch.testee": (1, 38, 1, 90, 0),
    "drain": (1, 100, 0, 0, 100),
}


def test_program_table_counts_ops_by_launch_and_idle_inside_spans():
    program = trace.summarize(_events(), 1000 * US).program
    assert set(program) == set(WANT)
    for name, (spans, host, ops, dev, idle) in WANT.items():
        got = program[name]
        assert got["spans"] == spans and got["device_ops"] == ops, name
        assert got["host_s"] == pytest.approx(host * US) and got["device_s"] == pytest.approx(dev * US), name
        assert got["idle_s"] == pytest.approx(idle * US, abs=1e-12), name


def test_existing_fields_are_the_parents():
    new, old = trace.summarize(_events(), 1000 * US), _parent_summarize(_events(), 1000 * US)
    assert new[:6] == tuple(old)
    assert "ssr:dispatch" not in new.by_name and new.span_count == {"decode": 1, "dispatch": 1, "testee": 1}


def test_an_unflagged_program_annotation_is_no_device_op():
    events = _events() + [_event("ssr:dispatch.testee", 262, 300, CUDA)]
    s = trace.summarize(events, 1000 * US)
    assert s.busy_s == pytest.approx((20 + 15 + 164) * US) and not any(k.startswith("ssr:") for k in s.by_name)


def test_span_table_matches_a_loop_over_every_op():
    """Bisection over the merged spans gives what a loop over every (op,
    span) pair gives, on overlapping spans of one name and shared launch
    times."""
    import random

    rng = random.Random(3)
    spans = []
    for _ in range(200):
        s = rng.uniform(0, 1e4)
        spans.append((rng.choice("abc"), s, s + rng.uniform(0, 300)))
    launches = {i: rng.uniform(0, 1e4) for i in range(1, 400)}
    device = []
    for i in range(1, 400):
        s = launches[i] + rng.uniform(0, 50)
        device.append((s, s + rng.uniform(1, 40), i if i % 7 else rng.randrange(1, 400)))
    got = trace.span_table(spans, device, launches)
    for name in "abc":
        ivs = [(s, e) for n, s, e in spans if n == name]
        inside = [(s, e) for s, e, cid in device if any(a <= launches[cid] <= b for a, b in ivs)]
        assert got[name]["device_ops"] == len(inside)
        assert got[name]["device_s"] == pytest.approx(sum(e - s for s, e in inside) * US)
        assert got[name]["spans"] == len(ivs)


# The summary as it was before the program table (frozen: the fields it
# returns must keep these values).
def _parent_summarize(events, window_s, n_gaps=10):
    dev, cpu = [], []
    for e in events:
        if e.device_type.name.upper().endswith("CUDA"):
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith("bench:"):
                dev.append(e)
        else:
            cpu.append(e)
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name] += (e.time_range.end - e.time_range.start) / 1e6

    spans = [e for e in cpu if e.name.startswith("bench:")]
    span_count = defaultdict(int)
    for s in spans:
        span_count[s.name[len("bench:"):]] += 1
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
                span_device_s[s.name[len("bench:"):]] += (k.time_range.end - k.time_range.start) / 1e6
    end_us = window_s * 1e6
    gaps = sorted(_parent_idle_gaps(intervals, 0.0, end_us), key=lambda g: -g[1])[:n_gaps]
    named = [(_parent_host_label(cpu, g0 + glen / 2), glen / 1e6) for g0, glen in gaps]
    clipped = [(max(0.0, s), min(end_us, e)) for s, e in intervals if e > 0 and s < end_us]
    return (_parent_union_seconds(clipped), window_s, dict(by_name), dict(span_device_s), dict(span_count), named)


def _parent_host_label(cpu, t):
    running = [e for e in cpu if e.time_range.start <= t <= e.time_range.end]
    if not running:
        return "host: no op (python, decode, helper)"
    return max(running, key=lambda e: e.time_range.start).name


def _parent_union_seconds(intervals):
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


def _parent_idle_gaps(intervals, start, end):
    gaps, at = [], start
    for s, e in sorted(intervals):
        if s > at:
            gaps.append((at, s - at))
        at = max(at, e)
    if end > at:
        gaps.append((at, end - at))
    return gaps


def test_existing_fields_are_the_parents_on_a_large_trace():
    """Nested spans of one name, kernels sharing a launch, launches outside
    every span and kernels with no launch: the same numbers, bit for bit,
    as the parent's loop over every (kernel, span) pair."""
    import random

    rng = random.Random(5)
    events, t = [], 0.0
    for b in range(40):
        for name in ("bench:decode", "bench:decode", "ssr:decode", "bench:dispatch", "bench:testee"):
            length = rng.uniform(50, 400)
            events.append(_event(name, t, t + length))
            t += rng.uniform(0, length)
        for i in range(30):
            launch = t + rng.uniform(-300, 300)
            cid = len(events) + 1
            events.append(_event("cudaLaunchKernel" if i % 5 else "cudaGraphLaunch", launch, launch + 2, id=cid))
            for _ in range(1 if i % 5 else 3):
                s = launch + rng.uniform(1, 20)
                events.append(_event(f"k{i % 7}", s, s + rng.uniform(0.1, 9.9), CUDA, cid if i % 11 else 0))
        t += rng.uniform(10, 100)
    new, old = trace.summarize(events, t * US), _parent_summarize(events, t * US)
    assert new[:6] == tuple(old) and list(new.span_device_s) == list(old[3])
    assert old[3]["decode"] > 0
