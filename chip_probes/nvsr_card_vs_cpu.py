#!/usr/bin/env python3
"""chip_smoke.py's NVSR card-vs-CPU check (the `nvsr` phase's comparison
on two short utterances), re-read on the card across seeds and repeated
card runs, beside a control that must fail it.

    python3 chip_probes/nvsr_card_vs_cpu.py [SEED ...]   # from the repository root, one card

For each seed (default NVSR_SEED and 0-5): NVSRTestee("unet") with the
seed's weights (flax's draw) on the CPU and on the card, through the
helper on the phase's two speech-like 1.5 s utterances at NVSR_CUTOFFS,
batch 2.  The card runs REPEATS times (a fresh helper each), each against
the one CPU run (and the later repeats against the first, card vs card):
the max per-pair |card - CPU| of the four metrics and of log-SiSpec's
|cos t| (chip_smoke.cos_delta), and the CPU run's log-SiSpec range over
the pairs.  At NVSR_SEED the CPU also runs twice (CPU vs CPU).
Control: the card with TF32 convolutions and matmuls
(init_checks.tf32_on_card) against the same CPU run.  Prints the card's
name and power limit first, then a JSON line per row and the max per
metric over the card rows and over the control rows.
"""
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from chip_probes.init_checks import tf32_on_card  # noqa: E402
from ssr_eval_tpu_torch.harness.fixtures import speechlike  # noqa: E402
from ssr_eval_tpu_torch.io.audio import write_wav  # noqa: E402
from ssr_eval_tpu_torch.models.testees import NVSRTestee  # noqa: E402

REPEATS = 3
KEYS = (*cs.METRICS, "log_sispec_cos")


def short_data(work):
    """The nvsr phase's two utterances (speechlike seeds 2000, 2001)."""
    root = os.path.join(work, "nvsr_short")
    os.makedirs(os.path.join(root, "p000"))
    for i in range(2):
        write_wav(os.path.join(root, "p000", f"s{i}.wav"), speechlike(cs.NVSR_SHORT_SECONDS, cs.SR, seed=2000 + i), cs.SR)
    return root


def run(testee, root, device=None):
    return cs._nvsr_helper(testee, root, cs.NVSR_CUTOFFS, 2, device=device, name="probe").evaluate(verbose=False)


def delta(a, b):
    """Max per-pair |a - b| of the four metrics and of |cos t|."""
    d, finite = cs._max_pair_delta(a, b)
    d["log_sispec_cos"] = cs.cos_delta(a, b)
    d["finite"] = finite
    return d


def main():
    seeds = [int(s) for s in sys.argv[1:]] or [cs.NVSR_SEED, 0, 1, 2, 3, 4, 5]
    print(cs.card_line(), flush=True)
    rows = []

    def add(row):
        rows.append(row)
        print(json.dumps(row), flush=True)

    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)  # the helper writes results/ into the working directory
        root = short_data(work)
        for seed in seeds:
            cpu = NVSRTestee(model_name="unet", seed=seed, device="cpu")
            res_cpu = run(cpu, root, "cpu")
            ls = [m["log_sispec"] for m in cs._pairs(res_cpu).values()]
            base = {"seed": seed, "cpu_log_sispec": [min(ls), float(np.median(ls)), max(ls)]}
            if seed == cs.NVSR_SEED:
                add(dict(base, kind="cpu_vs_cpu", delta=delta(run(cpu, root, "cpu"), res_cpu)))
            del cpu
            card = NVSRTestee(model_name="unet", seed=seed, device="cuda")
            first = None
            for r in range(REPEATS):
                res = run(card, root)
                add(dict(base, kind="card_vs_cpu", repeat=r, delta=delta(res, res_cpu)))
                if first is None:
                    first = res
                else:
                    add(dict(base, kind="card_vs_card", repeat=r, delta=delta(res, first)))
            with tf32_on_card():
                add(dict(base, kind="tf32_card_vs_cpu", delta=delta(run(card, root), res_cpu)))
            del card
            cs._free_card()
    for kind in ("card_vs_cpu", "card_vs_card", "tf32_card_vs_cpu", "cpu_vs_cpu"):
        got = [r["delta"] for r in rows if r["kind"] == kind]
        print(json.dumps({"kind": kind, "rows": len(got), "max": {k: max(g[k] for g in got) for k in KEYS},
                          "min": {k: min(g[k] for g in got) for k in KEYS}}), flush=True)


if __name__ == "__main__":
    main()
