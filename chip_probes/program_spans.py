#!/usr/bin/env python3
"""Where one benchmark cell's time goes, by the program's own spans and
counters (`engine.stats`, the `ssr:` spans of `utils.profiling`).

    python3 chip_probes/program_spans.py --workload noise_floor.leaderboard_sweep --seed 1 --seconds 20

From the root of a checkout (the program and `benchmark/` it imports are
the checkout's), on a CUDA card; `--device cpu` rehearses it at whatever
size the cell has.  Set-up is the benchmark's (`benchmark.run.prepare`);
then untraced jobs back to back for `--seconds`, then the traffic's
`trace_jobs` more under torch.profiler with the benchmark's own spans on
(`add_spans`, `SpanTestee`), as `python3 -m benchmark.run --trace 1` runs
them.  Prints one JSON object:

- from the untraced jobs, per batch: every span's host ms, the four
  dispatch children's sum over dispatch, decode.native over decode; per
  job: the spans counted (the decode stream's last, empty step is one
  more a pass), the helper's self time (job less job.evaluate_files); the
  padding share 100 x (1 - samples_real / samples_slots); the share of
  batches that replayed the engine's CUDA graphs (dispatch_graphed over
  dispatch_graphed + dispatch_eager), the graphs captured per job and in
  set-up, and the `dispatch.replay` ms a batch;
- from the traced jobs, per `ssr:` span name: spans, device ops launched
  inside (by correlation id), device ms of those ops, device idle ms inside
  the spans (their union less the device intervals); the longest idle gaps
  named by the innermost `ssr:` span and by the innermost host event (what
  the benchmark's breakdown prints);
- per `drain` span, whether it ended only after every device op launched
  before it began had finished (it waited for the newest batch, not only
  for the batch it collects), and by how much;
- a traced job's wall over an untraced one's (medians), and whether any
  `ssr:` event reached the benchmark's device-op table.

A checkout without the program's spans (an older commit) prints what it
can; the span fields are then empty.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import shutil
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.getcwd())

PROGRAM = "ssr:"
BENCH = "bench:"


def merged(intervals):
    """Sorted, disjoint union of [start, end) pairs."""
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


def within(union, t) -> bool:
    """Whether t lies in a sorted, disjoint interval list."""
    k = bisect.bisect_right(union, [t, float("inf")]) - 1
    return k >= 0 and union[k][0] <= t <= union[k][1]


def span_table(spans, device, launches):
    """spans: [(name, start, end)] (microseconds); device: [(start, end,
    correlation id)] of device ops; launches: {correlation id: host launch
    time}.  -> {name: {spans, device_ops, device_ms, idle_ms}}."""
    busy = merged([(s, e) for s, e, _ in device])
    by_name = {}
    for name, s, e in spans:
        by_name.setdefault(name, []).append((s, e))
    out = {}
    for name, ivs in by_name.items():
        union = merged(ivs)
        ops = [(s, e) for s, e, cid in device if cid in launches and within(union, launches[cid])]
        length = sum(e - s for s, e in union)
        out[name] = {"spans": len(ivs), "device_ops": len(ops), "device_ms": sum(e - s for s, e in ops) / 1e3,
                     "idle_ms": (length - overlap(union, busy)) / 1e3}
    return out


def gaps_by_span(spans, device, end, n=10):
    """The n longest device idle gaps in [0, end] as [innermost `ssr:`
    span at the gap's middle or None, ms]."""
    from benchmark.harness.trace import idle_gaps

    out = []
    for g0, glen in sorted(idle_gaps([(s, e) for s, e, _ in device], 0.0, end), key=lambda g: -g[1])[:n]:
        t = g0 + glen / 2
        running = [(s, name) for name, s, e in spans if s <= t <= e]
        out.append([max(running)[1] if running else None, glen / 1e3])
    return out


def drain_waits(spans, device, launches):
    """Per `drain` span: ms from the end of the last device op launched
    before the span began to the span's end (>= 0: the drain waited for
    everything queued before it).  -> {drains, waited_for_all, median and
    smallest ms after the last op}."""
    ops = sorted((launches[cid], e) for _, e, cid in device if cid in launches)
    at = [t for t, _ in ops]
    last_end, m = [], float("-inf")
    for _, e in ops:
        m = max(m, e)
        last_end.append(m)
    lags = []
    for name, s, e in spans:
        k = bisect.bisect_left(at, s)
        if name == "drain" and k:
            lags.append((e - last_end[k - 1]) / 1e3)
    if not lags:
        return None
    return {"drains": len(lags), "waited_for_all": sum(x >= 0 for x in lags),
            "median_ms_after_last_op": sorted(lags)[len(lags) // 2], "min_ms_after_last_op": min(lags)}


def analyse(events, window_s):
    from benchmark.harness import trace as bench_trace

    device, cpu = [], []
    for e in events:
        if bench_trace._is_device(e):
            if not getattr(e, "is_user_annotation", False) and not e.name.startswith((BENCH, PROGRAM)):
                device.append((e.time_range.start, e.time_range.end, e.id))
        else:
            cpu.append(e)
    launches = {e.id: e.time_range.start for e in cpu if e.name.startswith("cu") and e.id}
    spans = [(e.name[len(PROGRAM):], e.time_range.start, e.time_range.end) for e in cpu
             if e.name.startswith(PROGRAM)]
    summary = bench_trace.summarize(events, window_s)
    return {
        "spans": span_table(spans, device, launches),
        "idle_gaps_by_program_span": gaps_by_span(spans, device, window_s * 1e6),
        "drain_waits": drain_waits(spans, device, launches),
        "idle_gaps_as_the_benchmark_names_them": [list(g) for g in summary.gaps],
        "benchmark_device_ops_named_ssr": sorted(k for k in summary.by_name if k.startswith(PROGRAM)),
        "benchmark_busy_s": summary.busy_s,
        "device_ops": len(device),
    }


def delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)

    import torch

    from benchmark import run as bench_run
    from benchmark.harness import cells

    cuda = args.device == "cuda"
    if cuda and not torch.cuda.is_available():
        print("program_spans.py needs a CUDA card (or --device cpu)", file=sys.stderr)
        return 2
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cell = cells.load_cell(args.workload)
    home, workdir = os.getcwd(), tempfile.mkdtemp(prefix="ssr-spans-")
    try:
        os.chdir(workdir)
        prep = bench_run.prepare(cell, args.seed, args.device, workdir)
        helper, stats = prep.helper, prep.helper.engine.stats
        setup_captures = getattr(stats, "counters", {}).get("graph_captures", 0)
        evaluate = cell.traffic["evaluate"]

        def job():
            snap = (dict(stats.seconds), dict(stats.counts), dict(getattr(stats, "counters", {})))
            t = time.perf_counter()
            helper.evaluate(**evaluate)
            wall = time.perf_counter() - t
            return {"wall_s": wall, "seconds": delta(stats.seconds, snap[0]), "counts": delta(stats.counts, snap[1]),
                    "counters": delta(getattr(stats, "counters", {}), snap[2])}

        sync()
        plain, t0 = [], time.perf_counter()
        while time.perf_counter() - t0 < args.seconds:
            plain.append(job())
        sync()
        helper.testee.traced = True
        bench_run.add_spans(helper.engine)
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                      + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
        prof.start()
        t_trace = time.perf_counter()
        traced = [job() for _ in range(cell.traffic["trace_jobs"])]
        sync()
        window = time.perf_counter() - t_trace
        prof.stop()
        trace = analyse(prof.events(), window)
    finally:
        os.chdir(home)
        shutil.rmtree(workdir, ignore_errors=True)

    def total(jobs, part, key):
        return sum(j[part].get(key, 0) for j in jobs)

    batches = total(plain, "counts", "decode")
    per_batch = {k: 1e3 * total(plain, "seconds", k) / batches for k in sorted({k for j in plain for k in j["seconds"]})}
    children = ("dispatch.prep", "dispatch.target", "dispatch.degrade", "dispatch.testee", "dispatch.score",
                "dispatch.replay")
    real, slots = total(plain, "counters", "samples_real"), total(plain, "counters", "samples_slots")
    graphed, eager = total(plain, "counters", "dispatch_graphed"), total(plain, "counters", "dispatch_eager")
    t_batches = total(traced, "counts", "decode")
    spans = trace["spans"]
    out = {
        "workload": args.workload, "seed": args.seed,
        "card": torch.cuda.get_device_name(0) if cuda else "cpu",
        "jobs": len(plain), "batches_per_job": batches / len(plain),
        "job_ms_median": 1e3 * statistics.median(j["wall_s"] for j in plain),
        "traced_over_untraced_wall": statistics.median(j["wall_s"] for j in traced)
        / statistics.median(j["wall_s"] for j in plain),
        "ms_per_batch": per_batch,
        "dispatch_children_over_dispatch": (sum(per_batch.get(k, 0.0) for k in children) / per_batch["dispatch"]
                                            if per_batch.get("dispatch.prep") else None),
        "decode_native_over_decode": (per_batch["decode.native"] / per_batch["decode"]
                                      if "decode.native" in per_batch else None),
        "spans_per_job": sum(total(plain, "counts", k) for k in per_batch) / len(plain),
        "helper_self_ms_per_job": (1e3 * (total(plain, "seconds", "job") - total(plain, "seconds", "job.evaluate_files"))
                                   / len(plain) if "job" in per_batch else None),
        "pad_share": 100.0 * (1 - real / slots) if slots else None,
        "graphed_share": 100.0 * graphed / (graphed + eager) if graphed + eager else None,
        "graph_captures_per_job": total(plain, "counters", "graph_captures") / len(plain),
        "graph_captures_in_setup": setup_captures,
        "dispatch_replay_ms_per_batch": per_batch.get("dispatch.replay"),
        "traced": {
            "jobs": len(traced), "batches": t_batches, "window_s": window,
            "dispatch_device_ops_per_batch": (spans["dispatch"]["device_ops"] / t_batches
                                              if "dispatch" in spans else None),
            "decode_idle_ms_per_job": spans["decode"]["idle_ms"] / len(traced) if "decode" in spans else None,
            **trace,
        },
    }
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
