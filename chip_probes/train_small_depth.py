#!/usr/bin/env python3
"""Does the vocoder's training depth explain the small NVSR's LSD gap
between the card-trained artifacts and the JAX-trained ones?

    python3 chip_probes/train_small_depth.py     # from the repository root, one card

Runs `ssr_eval_tpu_torch.examples.train_small_nvsr`'s recipe on the card
twice, each into a temporary directory: as the recipe runs it (the vocoder
stops at probe correlation 0.65), and with that stop turned off, so the
vocoder trains its whole 3000-step cap.  Then scores, through
SSR_Eval_Helper on chip_smoke.py's two 1.5 s utterances at
TRAINED_CUTOFFS: each card-trained NVSRPostProcTestee, the JAX-trained
examples/trained_small one and the identity testee.  Prints, per variant,
the vocoder's steps, final loss and probe correlations, the generator's
final loss, and the LSD per cutoff.
"""
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
import ssr_eval_tpu_torch  # noqa: E402
from ssr_eval_tpu_torch.examples import train_small_nvsr as tsn  # noqa: E402
from ssr_eval_tpu_torch.harness.fixtures import speechlike  # noqa: E402
from ssr_eval_tpu_torch.io.audio import write_wav  # noqa: E402
from ssr_eval_tpu_torch.models.testees import NVSRPostProcTestee  # noqa: E402

VOCODER_CAP, GENERATOR_STEPS = cs.TRAIN_SMALL_STEPS


def _lsd(testee, root, name):
    res = cs._nvsr_helper(testee, root, cs.TRAINED_CUTOFFS, 2, name=name).evaluate(verbose=False)
    return {k: v["lsd"] for k, v in res["averaged"].items()}


def _testee(gen, voc):
    t = NVSRPostProcTestee(model_name="dnn")
    t.load_generator_checkpoint(gen)
    assert t.load_vocoder_checkpoint(voc, check=True) == []
    return t


def main():
    if not torch.cuda.is_available():
        sys.exit("train_small_depth.py needs a CUDA card")
    print(cs.card_line(), flush=True)
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
        for name, target in (("recipe_stop_0.65", tsn.VOCODER_TARGET_CORR), ("vocoder_full_cap", float("inf"))):
            tsn.VOCODER_TARGET_CORR = target
            res = tsn.train_small_nvsr(os.path.join(work, name), VOCODER_CAP, GENERATOR_STEPS, log_every=0)
            t = _testee(res["paths"]["generator"], res["paths"]["vocoder"])
            rows[name] = {
                "vocoder_steps": res["report"]["vocoder_steps_run"], "vocoder_final_loss": res["vocoder_losses"][-1],
                "probe_corr": res["probe_corr"], "sanity_corr": res["report"]["vocoder_sanity"]["corr"],
                "generator_final_loss": res["generator_losses"][-1], "seconds": res["seconds"],
                "lsd": _lsd(t, root, name),
            }
            print(f"[depth] {name}: {json.dumps(rows[name])}", flush=True)
            del res, t
            torch.cuda.empty_cache()
        os.chdir(ROOT)
    print(json.dumps(rows), flush=True)


if __name__ == "__main__":
    main()
