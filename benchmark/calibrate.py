"""Readings that the limits of a cell are set from, and its control.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1 2 3 ... [--control-seeds 3] [--out FILE]

For each seed, in one process on the card: the cell's set-up, one job
through the program, and the comparison with the float64 reference (the
program's reading); for the first `--control-seeds` seeds also the control:
the reference put in the program's place and computed in TF32 (float32 with
the operands of every product-sum rounded to TF32, the precision below the
configuration's float32 with TF32 off), and, for information, in plain
float32.  Each reading is one JSON line on standard output and in --out.
The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

from benchmark import run
from benchmark.harness import cells, compare
from benchmark.reference import dsp


def readings(cell: cells.Cell, seed: int, device: str, control: bool) -> dict:
    import torch

    workdir = tempfile.mkdtemp(prefix="ssr-calibrate-")
    home = os.getcwd()
    try:
        os.chdir(workdir)
        prep = run.prepare(cell, seed, device, workdir)
        result = prep.helper.evaluate(**cell.traffic["evaluate"])
        prep = prep._replace(helper=None)
        ref = run.reference_scores(cell, prep, device)
        out = {"seed": seed, "program": run.judge_all(cell, [result], ref)[0]}
        if control:
            speakers = cell.config["speakers"]
            for label, dtype, rnd in (("control_tf32", torch.float32, dsp.tf32),
                                      ("float32", torch.float32, dsp.identity)):
                low = run.reference_scores(cell, prep, device, dtype, rnd)
                out[label] = run.judge_all(cell, [run.as_result(low, speakers)], ref)[0]
        return out
    finally:
        os.chdir(home)
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    cell = cells.load_cell(args.workload)
    lines = []
    for i, seed in enumerate(args.seeds):
        line = readings(cell, seed, args.device, i < args.control_seeds)
        lines.append(line)
        print(json.dumps(line), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.writelines(json.dumps(x) + "\n" for x in lines)
    for k in compare.NUMBERS:
        prog = max(x["program"][k] for x in lines)
        ctl = [x["control_tf32"][k] for x in lines if "control_tf32" in x]
        print(f"[calibrate] {k}: program max {prog!r}; control min {min(ctl) if ctl else None!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
