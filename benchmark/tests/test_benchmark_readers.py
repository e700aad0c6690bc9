"""The readers of the program's own spans and counters (`Job.stats`,
`Summary.program`): a traced CPU run of each cell at the tests' tiny size,
every reader on a context that lacks the program's keys, and a new
configuration whose testee's own span and counter are read by files
alone."""

import json
import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.harness import cells, trace
from benchmark.tests.tiny import tiny_cell

CELLS = ["noise_floor.leaderboard_sweep", "noise_floor.quickstart_jobs"]
READERS = ["decode_native_ms_per_batch.thr", "decode_idle_ms_per_job.thr", "decode_idle_ms_per_job.job",
           "dispatch_prep_ms_per_batch.thr", "pad_share.thr", "pad_share.job", "graphed_share.thr",
           "graphed_share.job", "helper_self_ms_per_job.job"]


@pytest.mark.parametrize("name", CELLS)
def test_a_traced_cpu_run_reads_the_programs_spans_and_counters(name, monkeypatch, one_thread):
    seen = {}
    prepare, context = run.prepare, run.Context

    def prepared(*a, **k):
        prep = prepare(*a, **k)
        seen["stats"] = prep.helper.engine.stats
        seen["after_setup"] = run.stats_snapshot(seen["stats"])
        return prep

    def captured(**fields):
        seen["ctx"] = context(**fields)
        return seen["ctx"]

    monkeypatch.setattr(run, "prepare", prepared)
    monkeypatch.setattr(run, "Context", captured)
    line = run.run_cell(name, 2**31 + 29, 0.3, True, device="cpu", cell=tiny_cell(name))
    assert line["correct"], line["checks"]
    ctx = seen["ctx"]
    assert any(j.traced for j in ctx.jobs) and any(not j.traced for j in ctx.jobs)

    # Each job's delta: the engine's own totals since set-up, summed; the
    # stage seconds the existing readers read are the same numbers.
    end = run.stats_snapshot(seen["stats"])
    for group, table in end.items():
        for key, value in table.items():
            total = sum(j.stats[group].get(key, 0) for j in ctx.jobs)
            assert total == pytest.approx(value - seen["after_setup"][group].get(key, 0), abs=1e-9), (group, key)
    for j in ctx.jobs:
        assert j.stage_s == {k: j.stats["seconds"].get(k, 0.0) for k in run.STAGES}
        assert j.batches == j.stats["counts"]["decode"]

    values = {m: cells.metric_reader(m)(ctx) for m in READERS}
    assert all(v is None or isinstance(v, float) for v in values.values()), values
    for m in cells.load_cell(name).per_layer:
        if m["name"] in READERS:
            assert line["metrics"][m["name"]]["value"] == values[m["name"]]
    assert 0 <= values["pad_share.thr"] < 100 and values["pad_share.thr"] == values["pad_share.job"]
    assert values["graphed_share.thr"] == 0.0  # the CPU engine stays eager
    assert values["decode_idle_ms_per_job.thr"] > 0 and values["helper_self_ms_per_job.job"] > 0
    assert values["dispatch_prep_ms_per_batch.thr"] > 0
    assert ctx.trace.program["decode"]["spans"] >= sum(j.batches for j in ctx.jobs if j.traced)


@pytest.mark.parametrize("program", [None, {}])
@pytest.mark.parametrize("metric", READERS)
def test_a_reader_without_the_programs_keys_reads_none(metric, program):
    """A program that has none of these spans or counters (an older commit)
    leaves the metric out of the line."""
    empty = {"seconds": {}, "counts": {}, "counters": {}}
    job = run.Job(0.5, 16, 4, dict.fromkeys(run.STAGES, 0.1), 5, False, empty)
    tr = trace.Summary(busy_s=0.2, window_s=1.0, by_name={}, span_device_s={}, span_count={}, gaps=[],
                       program=program)
    ctx = SimpleNamespace(jobs=[job, job._replace(traced=True)], trace=tr, setup_s=1.0, work={}, specs=1,
                          expected_launches_per_batch=2, log=print)
    assert cells.metric_reader(metric)(ctx) is None


def _ctx(walls, traced, busy_s):
    empty = {"seconds": {}, "counts": {}, "counters": {}}
    jobs = [run.Job(w, 16, 4, dict.fromkeys(run.STAGES, 0.0), 5, t, empty) for w, t in zip(walls, traced)]
    tr = None if busy_s is None else trace.Summary(busy_s=busy_s, window_s=1.0, by_name={}, span_device_s={},
                                                   span_count={}, gaps=[], program={})
    return SimpleNamespace(jobs=jobs, trace=tr, setup_s=1.0, work={}, specs=1, expected_launches_per_batch=2,
                           log=print)


def test_job_device_ms_is_busy_seconds_per_profiled_job():
    read = cells.metric_reader("job_device_ms")
    ctx = _ctx([0.04] * 5 + [0.09] * 4, [False] * 5 + [True] * 4, 0.052)
    assert read(ctx) == pytest.approx(13.0)
    assert read(_ctx([0.04] * 3, [False] * 3, None)) is None
    assert read(_ctx([0.04, 0.09], [False, True], 0.0)) is None  # a trace with no device time: a CPU run


def test_job_p50_ms_job_reads_the_untraced_jobs_alone():
    ctx = _ctx([0.040, 0.050, 0.060, 0.500, 0.500, 0.500, 0.500], [False] * 3 + [True] * 4, 0.05)
    assert cells.metric_reader("job_p50_ms.job")(ctx) == pytest.approx(50.0)


@pytest.mark.parametrize("name", CELLS)
def test_an_untraced_run_profiles_only_for_a_device_trace_end_to_end_metric(name, monkeypatch, one_thread):
    """The quick-start cell's `job_device_ms` reads the trace of the jobs
    after the window in an untraced run too; the sweep profiles nothing
    there, as before."""
    seen, context = {}, run.Context

    def captured(**fields):
        seen["ctx"] = context(**fields)
        return seen["ctx"]

    monkeypatch.setattr(run, "Context", captured)
    cell = tiny_cell(name)
    line = run.run_cell(name, 2**31 + 41, 0.3, False, device="cpu", cell=cell)
    assert line["correct"], line["checks"]
    profiled = run.profiled_end_to_end(cell)
    assert profiled == (name == "noise_floor.quickstart_jobs")
    ctx = seen["ctx"]
    assert (ctx.trace is not None) == profiled
    assert sum(j.traced for j in ctx.jobs) == (cell.traffic["trace_jobs"] if profiled else 0)
    assert "busy_s" not in line["device"] and "breakdown" not in line
    assert "job_device_ms" not in line["metrics"]  # a CPU run reads no device time


TESTEE = '''"""The noise floor testee with a span and a counter of its own."""

from benchmark.testees.noise_floor import NoisyTestee


class SpannedFloor(NoisyTestee):
    def bind_stats(self, stats):
        self.stats = stats

    def infer_batch(self, x, lengths, state=None):
        with self.stats.stage("dispatch.testee.floor"):
            self.stats.add("floor_rows", int(x.shape[0]))
            return super().infer_batch(x, lengths, state)


def build(config, inputs, device, workdir):
    return SpannedFloor(inputs["floor"])
'''
PER_ROW = '''from benchmark.metrics._common import untraced


def read(ctx):
    jobs = untraced(ctx)
    rows = sum(j.stats["counters"].get("floor_rows", 0) for j in jobs)
    seconds = sum(j.stats["seconds"].get("dispatch.testee.floor", 0.0) for j in jobs)
    return 1e3 * seconds / rows if rows else None
'''
TRACED = '''def read(ctx):
    entry = (ctx.trace.program or {}).get("dispatch.testee.floor") if ctx.trace else None
    return None if entry is None else float(entry["spans"])
'''
RUN = '''import json, torch
torch.set_num_threads(1)
from benchmark import run
from benchmark.tests.tiny import tiny_cell
n = "spanned_floor.quickstart_jobs"
line = run.run_cell(n, 9, 0.3, True, device="cpu", cell=tiny_cell(n))
print(json.dumps([run.__file__, line]))
'''


def test_a_testees_own_span_and_counter_are_read_by_files_alone(tmp_path):
    """A later configuration brings a testee that opens a child span of
    `dispatch.testee` and counts through the engine's `stats`, and readers
    of both: new files and entries only, run from a checkout that holds
    them."""
    checkout = tmp_path / "checkout"
    bench_dir = checkout / "benchmark"
    shutil.copytree(cells.BENCH, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    config = json.loads((bench_dir / "configs" / "noise_floor.json").read_text())
    (bench_dir / "configs" / "spanned_floor.json").write_text(
        json.dumps(dict(config, name="spanned_floor", testee="spanned_floor")))
    (bench_dir / "testees" / "spanned_floor.py").write_text(TESTEE)
    (bench_dir / "workloads" / "spanned_floor.quickstart_jobs.json").write_text(
        (bench_dir / "workloads" / "noise_floor.quickstart_jobs.json").read_text())
    (bench_dir / "metrics" / "floor_ms_per_row.job.py").write_text(PER_ROW)
    (bench_dir / "metrics" / "floor_spans_traced.job.py").write_text(TRACED)
    bench = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
    cell = "spanned_floor.quickstart_jobs"
    bench["configs"].append({"name": "spanned_floor", "source": "https://github.com/haoheliu/ssr_eval",
                             "file": "benchmark/configs/spanned_floor.json", "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": cell, "config": "spanned_floor", "traffic": "quickstart_jobs", "chips": 1,
                               "why": "a test"})
    next(m for m in bench["end_to_end"] if m["name"] == "job_device_ms")["workloads"].append(cell)
    for name in ("floor_ms_per_row.job", "floor_spans_traced.job"):
        bench["per_layer"].append({"name": name, "unit": "ms", "better": "lower", "source": "program_span",
                                   "layer": "model testee", "moves": "job_device_ms", "workloads": [cell]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))

    env = dict(os.environ, PYTHONPATH=str(cells.ROOT))  # the program from this checkout, the benchmark from the copy
    out = subprocess.run([sys.executable, "-c", RUN], cwd=checkout, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    path, line = json.loads(out.stdout.strip().splitlines()[-1])
    assert path.startswith(str(checkout)) and line["correct"]
    assert line["metrics"]["floor_ms_per_row.job"]["value"] > 0
    assert line["metrics"]["floor_spans_traced.job"]["value"] >= 2
