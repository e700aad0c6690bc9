#!/usr/bin/env python3
"""Where the data-parallel generator step's extra time goes on the card.

    python3 chip_probes/dp_step_cost.py     # from the repository root, one card

Builds the kernels, joins a one-rank NCCL group, makes one mel-pair batch
(batch 8 x 1 s) and times, in turns over two rounds (median and best of 8
steps each): the plain trainer, `NVSRTrainer(mesh=make_mesh())`, the same
without the BatchNorm all-reduce, and the same without the gradient
all-reduce.  Then one plain and one DP step under torch.profiler, the top
ops by host (self CPU) time.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402
from ssr_eval_tpu_torch.harness.fixtures import speechlike  # noqa: E402
from ssr_eval_tpu_torch.models.data import MelPairPipeline  # noqa: E402
from ssr_eval_tpu_torch.models.train import NVSRTrainer, make_mesh  # noqa: E402
from ssr_eval_tpu_torch.models.unet import FlaxBatchNorm  # noqa: E402
from ssr_eval_tpu_torch.parallel.multihost import init_distributed  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("dp_step_cost.py needs a CUDA card")
    print(cs.card_line(), flush=True)
    cs.phase_build()
    init_distributed(f"localhost:{cs._free_port()}", 1, 0)
    audios = [speechlike(2.0, 44100, seed=s) for s in range(16)]
    pipe = MelPairPipeline(crop_seconds=1.0, cutoffs=cs.GEN_CUTOFFS)
    wav = pipe.random_crops(audios, np.random.default_rng(123), 8)
    mel_lr, mel_hr = pipe.make_pair(wav, 1)

    def timed(tr, st, n=8):
        tr.step(st, mel_lr, mel_hr)
        torch.cuda.synchronize()
        ts = []
        for _ in range(n):
            t = time.perf_counter()
            _, loss = tr.step(st, mel_lr, mel_hr)
            float(loss)  # synchronises
            ts.append(time.perf_counter() - t)
        return sorted(ts)[n // 2], min(ts)

    variants = {}
    tr = NVSRTrainer("unet")
    variants["plain"] = (tr, tr.init_state(seed=0))
    for name in ("dp", "dp_no_bn_sync", "dp_bn_sync_only"):
        tr = NVSRTrainer("unet", mesh=make_mesh())
        st = tr.init_state(seed=0)
        if name == "dp_no_bn_sync":
            for m in st["model"].modules():
                if isinstance(m, FlaxBatchNorm):
                    m.sync_stats = False
        if name == "dp_bn_sync_only":
            tr._average_over_ranks = lambda gen, loss: loss
        variants[name] = (tr, st)
    for round_ in range(2):
        for name, (tr, st) in variants.items():
            med, best = timed(tr, st)
            print(f"[cost] round {round_} {name}: median {med:.4f} best {best:.4f} s/step", flush=True)
    for name in ("plain", "dp"):
        tr, st = variants[name]
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            tr.step(st, mel_lr, mel_hr)
            torch.cuda.synchronize()
        print(f"[cost] {name} profile, top by self CPU time:", flush=True)
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=18, max_name_column_width=60),
              flush=True)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
