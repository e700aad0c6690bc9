"""The reader of the engine's `rows_dispatched` counter
(`rows_per_batch.nvsr`): a traced CPU run of each noise-floor cell at the
tests' tiny size, where a short batch carries its real rows alone, and a
context that lacks the counter, as an older program gives."""

import json
from types import SimpleNamespace

import pytest

from benchmark import run
from benchmark.harness import cells, trace
from benchmark.tests.tiny import tiny_cell

READER = "rows_per_batch.nvsr"


@pytest.mark.parametrize("name", ["noise_floor.leaderboard_sweep", "noise_floor.quickstart_jobs"])
def test_rows_per_batch_is_files_over_batches(name, monkeypatch, one_thread):
    seen, context = {}, run.Context

    def captured(**fields):
        seen["ctx"] = context(**fields)
        return seen["ctx"]

    monkeypatch.setattr(run, "Context", captured)
    cell = tiny_cell(name)
    line = run.run_cell(name, 2**31 + 29, 0.3, True, device="cpu", cell=cell)
    assert line["correct"], line["checks"]
    ctx = seen["ctx"]
    value = cells.metric_reader(READER)(ctx)
    # A batch carries its rows alone: one a file, whatever the batch size.
    plain = [j for j in ctx.jobs if not j.traced]
    assert value == sum(j.n_utts for j in plain) / sum(j.batches for j in plain)
    assert 1 <= value <= cell.workload["batch_size"]
    assert sum(j.stats["counters"]["rows_dispatched"] for j in plain) == sum(j.n_utts for j in plain)


@pytest.mark.parametrize("program", [None, {}])
def test_rows_per_batch_without_the_counter_reads_none(program):
    """A program without `rows_dispatched` (an older commit) leaves the
    metric out of the line."""
    empty = {"seconds": {}, "counts": {}, "counters": {}}
    job = run.Job(0.5, 16, 4, dict.fromkeys(run.STAGES, 0.1), 5, False, empty)
    tr = trace.Summary(busy_s=0.2, window_s=1.0, by_name={}, span_device_s={}, span_count={}, gaps=[],
                       program=program)
    ctx = SimpleNamespace(jobs=[job, job._replace(traced=True)], trace=tr, setup_s=1.0, work={}, specs=1,
                          expected_launches_per_batch=2, log=print)
    assert cells.metric_reader(READER)(ctx) is None


def test_rows_per_batch_is_declared_for_the_nvsr_cell_alone():
    per_layer = json.loads((cells.ROOT / "BENCHMARK.json").read_text())["per_layer"]
    entry = next(m for m in per_layer if m["name"] == READER)
    assert entry["layer"] == "engine" and entry["source"] == "program_counter" and entry["moves"] == "utt_per_s"
    assert entry["workloads"] == ["nvsr_unet_fp32.leaderboard_sweep"]
