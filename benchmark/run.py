"""Run one cell of the port's benchmark once.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  Set-up draws the dataset (a VCTK-layout tree
of FLAC files) and the testee's inputs from the seed, builds the testee and
an `SSR_Eval_Helper` of the port as a user would, and runs the traffic's
warm-up jobs.  The window then calls `helper.evaluate(...)` back to back
from one client, one call a job, until `--seconds` have passed; a job that
has started runs to its end.  After the window the program is freed, the
plain reference scores the same inputs in float64 on the same device, and
every job's return value is judged against it (harness/compare.py).

With --trace 0 the line reports the cell's end-to-end metrics; with
--trace 1 its per-layer metrics, from `engine.stats` over the window's
jobs (each job's delta of every span and counter), a torch.profiler trace
of `trace_jobs` more jobs run after the window (so the window's stage
times carry no profiler cost), and the work counts of harness/work.py.
A cell with an end-to-end metric from the device trace profiles those
jobs with --trace 0 as well.
The last line of standard output is one JSON object; the numbers compared
and their limits are the last lines of standard error.  Without a CUDA
card the run exits 2 and prints no result.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from typing import NamedTuple  # noqa: E402

from benchmark.harness import cells, compare, data, work  # noqa: E402
from benchmark.harness import trace as tracing  # noqa: E402
from benchmark.reference import dsp  # noqa: E402

# Top-level module names the process may not hold once the window closes:
# JAX, and the JAX package with the reference shim that imports it.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "ssr_eval_tpu", "ssr_eval"})
STAGES = ("decode", "dispatch", "drain", "host_infer", "codec_wait")


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of loaded modules that are forbidden, compared whole
    (`ssr_eval_tpu_torch` is not `ssr_eval_tpu`)."""
    names = sys.modules if modules is None else modules
    return sorted({n.split(".")[0] for n in names} & FORBIDDEN)


class Job(NamedTuple):
    wall_s: float
    n_utts: int
    batches: int
    stage_s: dict     # STAGES -> the job's host seconds in each
    launches: int
    traced: bool
    # The job's delta of every key of `engine.stats`: {"seconds": {span:
    # host s}, "counts": {span: spans}, "counters": {counter: n}}
    stats: dict


def stats_snapshot(stats) -> dict:
    """Copies of a `StageTimers`' three tables (an older program may keep
    no counters)."""
    return {"seconds": dict(stats.seconds), "counts": dict(stats.counts),
            "counters": dict(getattr(stats, "counters", {}))}


def stats_delta(after: dict, before: dict) -> dict:
    """Per table, every key of `after` less its value in `before`."""
    return {group: {k: v - before[group].get(k, 0) for k, v in table.items()} for group, table in after.items()}


class Context(NamedTuple):
    """What a metric reader may read (benchmark/metrics/<name>.py)."""
    jobs: list
    setup_s: float
    trace: tracing.Summary | None
    work: dict
    specs: int
    expected_launches_per_batch: int
    log: object


def job_files(config: dict, traffic: dict) -> list[tuple[str, str]]:
    """(speaker, file name) of every file one job scores, as evaluate()
    selects them (sorted names, the first limit_test_nums per speaker)."""
    limit = traffic["evaluate"].get("limit_test_nums", -1)
    per = {}
    for spk, name, _ in data.file_plan(config):
        per.setdefault(spk, []).append(name)
    out = []
    for spk in sorted(per):
        names = sorted(per[spk])
        out += [(spk, n) for n in (names[:limit] if limit > 0 else names)]
    return out


class SpanTestee:
    """The benchmark's thin wrapper around the testee: while `traced` it
    puts a "bench:testee" span around each infer_batch call."""

    def __init__(self, inner):
        self.inner = inner
        self.traced = False

    def device_state(self):
        return self.inner.device_state()

    def infer_batch(self, x, lengths, state=None):
        if not self.traced:
            return self.inner.infer_batch(x, lengths, state)
        import torch

        with torch.profiler.record_function(tracing.SPAN_PREFIX + "testee"):
            return self.inner.infer_batch(x, lengths, state)


def add_spans(engine) -> None:
    """For the traced jobs: a "bench:<stage>" span around each of the
    engine's stages, and "bench:decode" around each batch the decoder
    yields."""
    import torch

    stage = engine.stats.stage

    @contextlib.contextmanager
    def spanned(name):
        with torch.profiler.record_function(tracing.SPAN_PREFIX + name), stage(name):
            yield

    engine.stats.stage = spanned
    stream = engine._stream_batches

    def decoded(paths):
        it = stream(paths)
        while True:
            with torch.profiler.record_function(tracing.SPAN_PREFIX + "decode"):
                item = next(it, None)
            if item is None:
                return
            yield item

    engine._stream_batches = decoded


def log_fifths(jobs: list) -> None:
    """The median job wall time in each fifth of the window's jobs, so a
    drift within a run shows apart from a difference between runs."""
    if len(jobs) < 5:
        return
    n = len(jobs)
    meds = []
    for i in range(5):
        walls = sorted(j.wall_s for j in jobs[i * n // 5 : (i + 1) * n // 5])
        meds.append(walls[len(walls) // 2])
    log("job median by fifth of the window (ms): " + " ".join(f"{1e3 * m:.2f}" for m in meds))


def profiled_end_to_end(cell: cells.Cell) -> bool:
    """Whether an end-to-end metric of the cell reads the device trace, so
    that an untraced run profiles its after-window jobs too."""
    return any(m["source"] == "device_trace" for m in cell.end_to_end)


class Prepared(NamedTuple):
    helper: object
    pcm: dict
    inputs: dict


def prepare(cell: cells.Cell, seed: int, device: str, workdir: str) -> Prepared:
    """Set-up in `workdir` (the current directory): the dataset, the
    testee, the helper, and the traffic's warm-up jobs."""
    from ssr_eval_tpu_torch import SSR_Eval_Helper
    from ssr_eval_tpu_torch.io.audio import write_flac

    cfg, traffic = cell.config, cell.traffic
    t = time.perf_counter()
    inputs = cells.reference_module(cfg).inputs(cfg, seed)
    pcm = data.make_pcm(cfg, seed, device)
    t_data = time.perf_counter()
    root = data.write_tree(os.path.join(workdir, "vctk"), pcm, cfg["native_sr"], write_flac)
    t_write = time.perf_counter()
    inner = cells.testee_module(cfg).build(cfg, inputs, device, workdir)
    helper = SSR_Eval_Helper(SpanTestee(inner), test_data_root=root, batch_size=cell.workload["batch_size"],
                             device=None if device == "cuda" else device, **traffic["helper"])
    if hasattr(inner, "bind_stats"):
        # The testee's own spans and counters go into the engine's tracer.
        inner.bind_stats(helper.engine.stats)
    t_build = time.perf_counter()
    for _ in range(traffic["warmup_jobs"]):
        helper.evaluate(**traffic["evaluate"])
    log(f"set-up: data {t_data - t:.3f} s, FLAC {t_write - t_data:.3f} s, testee and helper "
        f"{t_build - t_write:.3f} s, {traffic['warmup_jobs']} warm-up jobs {time.perf_counter() - t_build:.3f} s")
    return Prepared(helper, pcm, inputs)


def reference_scores(cell: cells.Cell, prep: Prepared, device: str, dtype=None, rnd=dsp.identity) -> dict:
    """{(speaker, file name): {spec key: {metric: value}}} of the plain
    reference (float64 unless `dtype` says otherwise) for one job's files."""
    import torch

    cfg, traffic = cell.config, cell.traffic
    h = traffic["helper"]
    plan = {k: h[k] for k in ("input_sr", "output_sr", "evaluation_sr")}
    families = cells.degradations(h)

    def degrade(x, rnd):
        return cells.spec_keys(h), torch.cat([mod.degrade(x, st, h["input_sr"], rnd) for mod, st in families])

    testee = cells.reference_module(cfg).build(cfg, prep.inputs, device)
    return {
        f: dsp.pipeline(prep.pcm[f], cfg["native_sr"], plan, degrade, testee, dtype or torch.float64, device, rnd)
        for f in job_files(cfg, traffic)
    }


def as_result(scores: dict, speakers: list) -> dict:
    """Per-file scores -> the shape evaluate() returns, with `each_speaker`
    and `averaged` as the reference's mean reduction makes them."""
    out = {spk: {} for spk in speakers}
    for (spk, name), per in scores.items():
        out[spk][name] = per
    each = {
        spk: {k: {m: float(sum(f[k][m] for f in out[spk].values()) / len(out[spk])) for m in compare.METRICS}
              for k in next(iter(out[spk].values()))}
        for spk in speakers
    }
    out["each_speaker"] = each
    out["averaged"] = {
        k: {m: float(sum(each[s][k][m] for s in speakers) / len(speakers)) for m in compare.METRICS}
        for k in each[speakers[-1]]
    }
    return out


def judge_all(cell: cells.Cell, results: list, reference: dict):
    """-> (largest numbers over the jobs, jobs failed, first reason)."""
    speakers = cell.config["speakers"]
    n_per = len(reference) // len(speakers)
    ref_averaged = as_result(reference, speakers)["averaged"]
    keys = cells.spec_keys(cell.traffic["helper"])
    worst, failed, first = dict.fromkeys(compare.NUMBERS, 0.0), 0, None
    for i, r in enumerate(results):
        nums, reason = compare.judge(r, reference, ref_averaged, speakers, n_per, keys, cell.workload["limits"])
        worst = {k: max(worst[k], v) for k, v in nums.items()}
        if reason:
            failed += 1
            first = first or f"job {i}: {reason}"
    return worst, failed, first


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             cell: cells.Cell | None = None, t0: float = _T0) -> dict:
    """One run of a cell -> the result line (a dict)."""
    cell = cell or cells.load_cell(name)
    import torch

    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel

    log(f"imports {time.perf_counter() - t0:.3f} s")

    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    cfg, traffic = cell.config, cell.traffic
    specs = len(cells.spec_keys(traffic["helper"]))
    files = job_files(cfg, traffic)

    workdir = tempfile.mkdtemp(prefix="ssr-bench-")
    home = os.getcwd()
    try:
        os.chdir(workdir)
        prep = prepare(cell, seed, device, workdir)
        helper, stats = prep.helper, prep.helper.engine.stats
        sync()
        setup_s = time.perf_counter() - t0

        jobs, results, failed_runs = [], [], 0

        def job(traced: bool) -> bool:
            """Run one job; -> False when it raised."""
            s0 = {k: stats.seconds.get(k, 0.0) for k in STAGES}
            b0, l0 = stats.counts.get("decode", 0), stft_magnitude_kernel.launches
            snap = stats_snapshot(stats)
            tj = time.perf_counter()
            try:
                results.append(helper.evaluate(**traffic["evaluate"]))
            except Exception:
                log(traceback.format_exc())
                return False
            jobs.append(Job(time.perf_counter() - tj, len(files), stats.counts.get("decode", 0) - b0,
                            {k: stats.seconds.get(k, 0.0) - s0[k] for k in STAGES},
                            stft_magnitude_kernel.launches - l0, traced, stats_delta(stats_snapshot(stats), snap)))
            return True

        t_start = time.perf_counter()
        while time.perf_counter() - t_start < seconds:
            if not job(False):
                failed_runs += 1
                break
        sync()
        window_s = time.perf_counter() - t_start
        log_fifths(jobs)
        # A traced run, or a cell with an end-to-end metric read from the
        # device trace, profiles `trace_jobs` more jobs after the window, so
        # the window's times carry no profiler cost.
        prof = None
        if (trace or profiled_end_to_end(cell)) and not failed_runs:
            helper.testee.traced = True
            add_spans(helper.engine)
            prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]
                                          + ([torch.profiler.ProfilerActivity.CUDA] if cuda else []))
            prof.start()
            t_trace = time.perf_counter()
            for _ in range(traffic["trace_jobs"]):
                if not job(True):
                    failed_runs += 1
                    break
            sync()
            trace_window = time.perf_counter() - t_trace
            prof.stop()
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        summary = None
        if prof is not None:
            t_sum = time.perf_counter()
            events = prof.events()
            t_events = time.perf_counter()
            summary = tracing.summarize(events, trace_window)
            log(f"trace: {len(events)} events read in {t_events - t_sum:.3f} s, "
                f"summarised in {time.perf_counter() - t_events:.3f} s")
            del events
        del helper, stats, prof
        prep = prep._replace(helper=None)
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        t_ref = time.perf_counter()
        reference = reference_scores(cell, prep, device)
        log(f"window {window_s:.3f} s, {len(jobs)} jobs; reference {time.perf_counter() - t_ref:.3f} s")
        worst, failed, reason = judge_all(cell, results, reference)
        failed += failed_runs
        if reason:
            log(reason)
    finally:
        os.chdir(home)
        shutil.rmtree(workdir, ignore_errors=True)

    lengths = [len(prep.pcm[f]) for f in files]
    ctx = Context(
        jobs=jobs, setup_s=setup_s, trace=summary,
        work=work.job_work(lengths, cfg["native_sr"], traffic["helper"], cfg, cells.degradations(traffic["helper"])),
        specs=specs,
        expected_launches_per_batch=cfg["stft_launches"]["per_batch"] + cfg["stft_launches"]["per_spec"] * specs,
        log=log,
    )
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cells.metric_reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = len(jobs) + failed_runs
    line = {
        "correct": attempted > 0 and failed == 0,
        "attempted": attempted,
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if trace and summary is not None:
        line["device"].update(busy_s=summary.busy_s, window_s=summary.window_s)
        ops = sorted(summary.by_name.items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [list(o) for o in ops], "idle_gaps": [list(g) for g in summary.gaps]}
    line["checks"] = {k: {"value": worst[k], "limit": cell.workload["limits"][k]} for k in compare.NUMBERS}
    return line


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"needs {cell.chips} CUDA card(s); this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), cell=cell)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for k, v in line["checks"].items():
        print(f"[check] {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
