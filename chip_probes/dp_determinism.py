#!/usr/bin/env python3
"""How deterministic is one full-width NVSR generator step on the card, and
does the data-parallel step at world size 1 change it?

    python3 chip_probes/dp_determinism.py     # from the repository root, one card

Builds the kernels, joins a one-rank NCCL group, makes one mel-pair batch
(examples/train_nvsr.py's configuration: batch 8 x 1 s) and, under cuDNN's
default algorithms, under `cudnn.deterministic` and under
`torch.use_deterministic_algorithms`, takes one step from seed 0 with two
plain trainers and one `NVSRTrainer(mesh=make_mesh())`.  Prints, per mode,
the worst gradient leaves of plain vs plain and DP vs plain, over the
model's largest gradient and over the leaf's own max.
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # cuBLAS determinism, read at start-up
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ssr_eval_tpu_torch.harness.fixtures import speechlike  # noqa: E402
from ssr_eval_tpu_torch.models.data import MelPairPipeline  # noqa: E402
from ssr_eval_tpu_torch.models.train import NVSRTrainer, make_mesh  # noqa: E402
from ssr_eval_tpu_torch.parallel.multihost import init_distributed  # noqa: E402


def main():
    if not torch.cuda.is_available():
        sys.exit("dp_determinism.py needs a CUDA card")
    print(cs.card_line(), flush=True)
    cs.phase_build()
    init_distributed(f"localhost:{cs._free_port()}", 1, 0)
    audios = [speechlike(2.0, 44100, seed=s) for s in range(16)]
    pipe = MelPairPipeline(crop_seconds=1.0, cutoffs=cs.GEN_CUTOFFS)
    wav = pipe.random_crops(audios, np.random.default_rng(123), 8)
    mel_lr, mel_hr = pipe.make_pair(wav, 1)

    def one(mesh):
        tr = NVSRTrainer("unet", learning_rate=1e-4, mesh=mesh)
        st, loss = tr.step(tr.init_state(seed=0), mel_lr, mel_hr)
        g = cs._grads_of(st["model"])
        del tr, st
        return float(loss), g

    def report(tag, ref, got):
        gmax = max(v.abs().max().item() for v in ref[1].values())
        rows = []
        for k, r in ref[1].items():
            d = (got[1][k] - r).abs().max().item()
            rows.append((d / gmax, d / max(r.abs().max().item(), 1e-30), k))
        worst = "; ".join(f"{a:.3e} {b:.3e} {k}" for a, b, k in sorted(rows, reverse=True)[:6])
        print(f"{tag}: loss {ref[0]:.8f} {got[0]:.8f}; worst (of model max, of own max, leaf): {worst}", flush=True)

    for mode in ("default", "cudnn_det", "strict"):
        torch.backends.cudnn.deterministic = mode != "default"
        torch.backends.cudnn.benchmark = False
        torch.use_deterministic_algorithms(mode == "strict")
        try:
            a, b, d = one(None), one(None), one(make_mesh())
            report(f"[{mode}] plain vs plain", a, b)
            report(f"[{mode}] dp vs plain", a, d)
        except RuntimeError as e:  # an op without a deterministic version
            print(f"[{mode}] failed: {e}", flush=True)
    torch.use_deterministic_algorithms(False)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
