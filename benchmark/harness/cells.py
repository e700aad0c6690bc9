"""Finding a cell's files by name.

`BENCHMARK.json` names each cell's configuration and traffic; the harness
reads `benchmark/configs/<config>.json` (the testee and the dataset),
`benchmark/traffic/<traffic>.json` (the helper's settings and one job's
`evaluate()` arguments) and `benchmark/workloads/<cell>.json` (batch size,
limits), the testee and reference modules the configuration names under
`benchmark/testees/` and `benchmark/reference/`, one module
`benchmark/degrade/<family>.py` for each `setting_<family>` of the traffic,
and one reader `benchmark/metrics/<metric>.py` for each metric the cell
reports.
"""

from __future__ import annotations

import functools
import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    workload: dict
    end_to_end: list   # BENCHMARK.json entries this cell reports
    per_layer: list


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, benchmark: dict | None = None, bench_dir: Path = BENCH) -> Cell:
    """The cell `name` of `benchmark` (default: the checkout's
    BENCHMARK.json) with its files from `bench_dir`."""
    bench = benchmark or _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    moved = {m["name"] for m in e2e}
    per_layer = [
        m for m in bench["per_layer"]
        if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)
    ]
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=_json(bench_dir / "configs" / f"{entry['config']}.json"),
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        workload=_json(bench_dir / "workloads" / f"{name}.json"),
        end_to_end=e2e,
        per_layer=per_layer,
    )


def testee_module(config: dict):
    return importlib.import_module(f"benchmark.testees.{config['testee']}")


def reference_module(config: dict):
    return importlib.import_module(f"benchmark.reference.{config['reference']}")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=None)
def degrade_module(family: str, bench_dir: Path = BENCH):
    """benchmark/degrade/<family>.py: spec_keys, degrade, flop."""
    return _load(bench_dir / "degrade" / f"{family}.py", f"benchmark.degrade._{family}")


def degradations(helper: dict, bench_dir: Path = BENCH) -> list:
    """[(family module, its settings)] for every `setting_<family>` that the
    traffic's helper settings give, in the order they are given."""
    return [
        (degrade_module(key[len("setting_"):], bench_dir), value)
        for key, value in helper.items() if key.startswith("setting_") and value
    ]


def spec_keys(helper: dict, bench_dir: Path = BENCH) -> list[str]:
    """The spec keys one file's result holds, as the program names them."""
    return [k for mod, s in degradations(helper, bench_dir) for k in mod.spec_keys(s, helper["input_sr"])]


def metric_reader(name: str, bench_dir: Path = BENCH):
    """The `read(ctx)` of benchmark/metrics/<name>.py (names may hold dots)."""
    return _load(bench_dir / "metrics" / f"{name}.py", f"benchmark.metrics._{name.replace('.', '_')}").read
