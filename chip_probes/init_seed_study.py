#!/usr/bin/env python3
"""How far does the vocoder's random init move the small NVSR's score?

    python3 chip_probes/init_seed_study.py [SEED ...]   # from the repository root, one card

Runs `ssr_eval_tpu_torch.examples.train_small_nvsr`'s recipe on the card
once per vocoder init seed (default 0-3), each into a temporary directory,
at chip_smoke.py's counts (TRAIN_SMALL_STEPS: the vocoder stops at probe
correlation 0.65 within a 3000-step cap, then 300 generator steps).  Only
the vocoder's weights change with the seed: the recipe's `fit` draws them
with `init_state(seed=0)`, which this script redirects to the study's
seed; the crops, the generator and everything after stay the recipe's.
Seed 0 is the recipe as it ships.

Each run is scored as `chip_probes/train_small_depth.py` scores it:
through SSR_Eval_Helper on chip_smoke.py's two 1.5 s utterances at
TRAINED_CUTOFFS (4 / 8 / 12 kHz), beside the identity testee and the
JAX-trained examples/trained_small.  Prints the card's name and power
limit, the torch version and whether `trunc_normal_` and `orthogonal_`
take a generator, a line per seed, then the mean and range of the LSD per
cutoff.
"""
import inspect
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import ssr_eval_tpu_torch  # noqa: E402
from ssr_eval_tpu_torch.examples import train_small_nvsr as tsn  # noqa: E402
from ssr_eval_tpu_torch.harness.fixtures import speechlike  # noqa: E402
from ssr_eval_tpu_torch.io.audio import write_wav  # noqa: E402
from ssr_eval_tpu_torch.models.train_vocoder import VocoderTrainer  # noqa: E402
from train_small_depth import GENERATOR_STEPS, VOCODER_CAP, _lsd, _testee  # noqa: E402  (this directory)


def _train(out, seed):
    """The recipe with the vocoder drawn from `seed`."""
    init_state = VocoderTrainer.init_state
    VocoderTrainer.init_state = lambda self, _seed=0, params=None: init_state(self, seed, params)
    try:
        return tsn.train_small_nvsr(out, VOCODER_CAP, GENERATOR_STEPS, log_every=0)
    finally:
        VocoderTrainer.init_state = init_state


def main():
    if not torch.cuda.is_available():
        sys.exit("init_seed_study.py needs a CUDA card")
    seeds = [int(s) for s in sys.argv[1:]] or [0, 1, 2, 3]
    takes_gen = {f: "generator" in inspect.signature(getattr(torch.nn.init, f)).parameters
                 for f in ("trunc_normal_", "orthogonal_")}
    print(cs.card_line(), flush=True)
    print(f"[seeds] torch {torch.__version__} (CUDA {torch.version.cuda}); generator= taken: {json.dumps(takes_gen)}",
          flush=True)
    if not all(takes_gen.values()):
        sys.exit("torch.nn.init does not take generator= here")
    cs.phase_build()
    with tempfile.TemporaryDirectory() as work:
        os.chdir(work)  # the helper writes results/ here
        root = os.path.join(work, "nvsr_short")
        os.makedirs(os.path.join(root, "p000"))
        for i in range(2):  # phase_nvsr's utterances
            x = speechlike(cs.NVSR_SHORT_SECONDS, cs.SR, seed=2000 + i)
            write_wav(os.path.join(root, "p000", f"s{i}.wav"), x, cs.SR)
        rows = {"identity": {"lsd": _lsd(ssr_eval_tpu_torch.BatchedTestee(), root, "identity")}}
        art = os.path.join(ROOT, "examples", "trained_small")
        jax_t = _testee(os.path.join(art, "generator_dnn.npz"), os.path.join(art, "vocoder_small_trained.pt"))
        rows["jax_trained"] = {"lsd": _lsd(jax_t, root, "jax_trained")}
        for seed in seeds:
            res = _train(os.path.join(work, f"seed_{seed}"), seed)
            t = _testee(res["paths"]["generator"], res["paths"]["vocoder"])
            rows[f"seed_{seed}"] = {
                "vocoder_steps": res["report"]["vocoder_steps_run"], "vocoder_final_loss": res["vocoder_losses"][-1],
                "probe_corr": res["probe_corr"], "sanity_corr": res["report"]["vocoder_sanity"]["corr"],
                "generator_final_loss": res["generator_losses"][-1], "seconds": res["seconds"],
                "lsd": _lsd(t, root, f"seed_{seed}"),
            }
            print(f"[seeds] seed {seed}: {json.dumps(rows[f'seed_{seed}'])}", flush=True)
            del res, t
            torch.cuda.empty_cache()
        os.chdir(ROOT)
    per_cut = {k: [rows[f"seed_{s}"]["lsd"][k] for s in seeds] for k in rows["identity"]["lsd"]}
    summary = {k: {"mean": float(np.mean(v)), "min": min(v), "max": max(v)} for k, v in per_cut.items()}
    print(f"[seeds] LSD over seeds {seeds}: {json.dumps(summary)}; identity {json.dumps(rows['identity']['lsd'])}; "
          f"JAX-trained {json.dumps(rows['jax_trained']['lsd'])}", flush=True)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
