"""BENCHMARK.json and the files the harness finds by name."""

import json
import re
import shutil

import pytest

from benchmark.harness import cells

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    n = len(BENCH["workloads"])
    assert 2 + 14 * 24 <= 43200 and (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, n // 4)
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names) and all(NAME.match(x) for x in names)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" and m["bound"] == 0.25 for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    layers = {}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        layers.setdefault(m["layer"], m["layer"])
        if m["unit"] == "%":
            assert m["better"] in ("higher", "lower")


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_loads_with_its_readers(name):
    cell = cells.load_cell(name)
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.metric_reader(m["name"]))
    assert cells.testee_module(cell.config) and cells.reference_module(cell.config)
    assert set(cell.workload["limits"]) == {"lsd_mean", "log_sispec_mean", "sispec_db", "ssim", "aggregate"}


def test_a_new_cell_and_metric_are_found_without_edits(tmp_path):
    """A later change adds a cell and a metric as files alone."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    traffic = json.loads((bench_dir / "traffic" / "quickstart_jobs.json").read_text())
    traffic["evaluate"]["limit_test_nums"] = 4
    (bench_dir / "traffic" / "validation_4.json").write_text(json.dumps(traffic))
    (bench_dir / "workloads" / "noise_floor.validation_4.json").write_text(
        (bench_dir / "workloads" / "noise_floor.quickstart_jobs.json").read_text())
    (bench_dir / "metrics" / "jobs_in_window.job.py").write_text("def read(ctx):\n    return len(ctx.jobs)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "noise_floor.validation_4", "config": "noise_floor",
                               "traffic": "validation_4", "chips": 1, "why": "four files a speaker"})
    next(m for m in bench["end_to_end"] if m["name"] == "job_device_ms")["workloads"].append("noise_floor.validation_4")
    bench["per_layer"].append({"name": "jobs_in_window.job", "unit": "jobs", "better": "higher",
                               "source": "host_clock", "layer": "helper", "moves": "job_device_ms"})
    cell = cells.load_cell("noise_floor.validation_4", bench, bench_dir)
    assert cell.traffic["evaluate"]["limit_test_nums"] == 4 and cell.workload["batch_size"] == 4
    assert [m["name"] for m in cell.end_to_end] == ["job_device_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["jobs_in_window.job"]
    assert cells.metric_reader("jobs_in_window.job", bench_dir)(type("C", (), {"jobs": [1, 2]})()) == 2


def test_a_new_degradation_family_is_found_without_edits(tmp_path):
    """A family module added as a file names its specs for the harness."""
    bench_dir = tmp_path / "benchmark"
    shutil.copytree(cells.BENCH, bench_dir, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (bench_dir / "degrade" / "halving.py").write_text(
        "def spec_keys(settings, sr):\n"
        "    return [f'proc_halving_{g}_{sr}' for g in settings['gains']]\n")
    helper = {"input_sr": 44100, "setting_fft": {"cutoff_freq": [4000]}, "setting_halving": {"gains": [1, 2]},
              "setting_subsampling": None}
    assert cells.spec_keys(helper, bench_dir) == ["proc_fft_8000_44100", "proc_halving_1_44100",
                                                  "proc_halving_2_44100"]
