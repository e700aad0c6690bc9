"""Train the small NVSR (the dnn generator and the small TFGAN vocoder) and
write its artifacts (counterpart of scripts/train_small_nvsr.py, with the
same recipe).

    python -m ssr_eval_tpu_torch.examples.train_small_nvsr [vocoder_steps] [generator_steps] \\
        [--out DIR] [--device cuda|cpu]

Runs on the CUDA card unless `--device cpu` is given.  Writes into --out
(default `trained_small/` in the port's build directory, `_paths.build_dir()`:
`ssr_eval_tpu_torch/_build/` in a checkout, which git ignores, the user cache
in a read-only install):
  vocoder_small_trained.pt   the trained vocoder as a voicefixer-layout
                             torch state dict
  generator_dnn.npz          the trained dnn generator as the JAX package's
                             variables tree ({"params", "batch_stats"})
  train_report.json          losses and the vocoder's sanity report
Both packages load them: `NVSRTestee.load_generator_checkpoint` and
`load_vocoder_checkpoint`.  The checked-in `examples/trained_small/` holds
the JAX package's artifacts, which the tests read; this script refuses to
write there.

The vocoder trains in chunks of 500 steps and stops once its probe
correlation reaches 0.65 (the load-time check asks for more than 0.5), or
at `vocoder_steps`.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ssr_eval_tpu_torch._paths import PKG, build_dir
from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.models.checkpoint import save_variables_npz
from ssr_eval_tpu_torch.models.testees import NVSRTestee
from ssr_eval_tpu_torch.models.train import NVSRTrainer
from ssr_eval_tpu_torch.models.train_vocoder import SMALL_TFGAN, VocoderTrainer, export_torch_state_dict
from ssr_eval_tpu_torch.models.vocoder_check import probe_signal, synthesis_report

DEFAULT_OUT = str(build_dir() / "trained_small")
CHECKED_IN = str(PKG.parent / "examples" / "trained_small")

SR = 44100
VOCODER_CHUNK = 500
VOCODER_TARGET_CORR = 0.65
GENERATOR_CUTOFFS = (1000, 2000, 4000, 6000, 8000, 12000, 16000)


def harmonic_stack(duration_s, sr, seed):
    """Sparse vibrato'd harmonic stack under a smooth envelope, the
    probe_signal family.  It leaves most of the mel range near-silent, which
    teaches the vocoder to stay quiet where the conditioning is quiet."""
    rng = np.random.default_rng(seed)
    n = int(duration_s * sr)
    t = np.arange(n) / sr
    f0 = (120.0 + 80.0 * rng.random()) + (20.0 + 30.0 * rng.random()) * np.sin(
        2 * np.pi * (1.5 + 2.0 * rng.random()) * t
    )
    phase = 2 * np.pi * np.cumsum(f0) / sr
    kmax = int(rng.integers(3, 9))
    x = sum((0.5 / k) * np.sin(k * phase + rng.random() * 6.28) for k in range(1, kmax + 1))
    env = 0.3 + 0.7 * np.hanning(n)
    return (0.5 * x * env).astype(np.float32)


def training_audios():
    """48 clips of 2 s at 44.1 kHz: speechlike (full band, seeds 0-23),
    sparse harmonic stacks (seeds 100-111) and FFT-lowpassed speechlike
    (seeds 200-211, cutoffs ~1.3-8.5 kHz)."""
    out = [speechlike(2.0, SR, seed=s) for s in range(24)]
    out += [harmonic_stack(2.0, SR, seed=100 + s) for s in range(12)]
    for s in range(12):
        x = speechlike(2.0, SR, seed=200 + s)
        X = np.fft.rfft(x.astype(np.float64))
        cut = int(len(X) * (0.06 + 0.03 * s))
        X[cut:] = 0.0
        out.append(np.fft.irfft(X, n=len(x)).astype(np.float32))
    return out


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_out(out):
    if os.path.realpath(out) == os.path.realpath(CHECKED_IN):
        raise ValueError(
            f"refusing to write into {CHECKED_IN}: it holds the JAX package's trained artifacts, "
            f"which the tests read; pick another --out (default {DEFAULT_OUT})"
        )


def train_small_nvsr(out=DEFAULT_OUT, vocoder_steps=400, generator_steps=300, device=None, check=True,
                     log_every=100):
    """Run the recipe and write the three artifacts into `out`.

    check: run the vocoder's load-time sanity check when the artifacts are
    assembled into an NVSRTestee (a few steps do not pass it).  Returns a
    dict: "report" (train_report.json's content), "paths", the per-step
    losses, "probe_corr" ([(steps, corr)] after each chunk),
    "generator_variables" (the tree saved), "seconds" per stage, and
    "testee" (the assembled NVSRTestee on `device`)."""
    _check_out(out)
    dev = resolve_device(device)
    os.makedirs(out, exist_ok=True)
    audios = training_audios()
    seconds = {}

    vt = VocoderTrainer(SMALL_TFGAN, device=dev)
    probe = probe_signal(SR)
    state, v_losses, corrs = None, [], []
    t = time.perf_counter()
    for start in range(0, vocoder_steps, VOCODER_CHUNK):
        n = min(VOCODER_CHUNK, vocoder_steps - start)
        state, losses = vt.fit(audios, steps=n, batch=4, crop_seconds=0.35, seed=start, state=state,
                               log_every=log_every)
        v_losses += losses
        corr = vt.probe_corr(state["model"], probe)
        corrs.append((start + n, corr))
        print(f"[vocoder] step {start + n} loss {v_losses[-1]:.4f} probe_corr {corr:.4f}", flush=True)
        if corr >= VOCODER_TARGET_CORR:
            break
    _sync(dev)
    seconds["vocoder"] = time.perf_counter() - t
    voc_path = os.path.join(out, "vocoder_small_trained.pt")
    export_torch_state_dict(state["model"], SMALL_TFGAN, voc_path)
    print(f"[vocoder] exported {voc_path}", flush=True)

    gt = NVSRTrainer(model_name="dnn", learning_rate=3e-4, device=dev)
    t = time.perf_counter()
    g_state, g_losses = gt.fit(audios, steps=generator_steps, batch=8, crop_seconds=1.0,
                               cutoffs=GENERATOR_CUTOFFS, log_every=log_every)
    _sync(dev)
    seconds["generator"] = time.perf_counter() - t
    g_vars = gt.variables(g_state)
    gen_path = save_variables_npz(os.path.join(out, "generator_dnn.npz"), g_vars)
    print(f"[generator] saved {gen_path}", flush=True)

    # assemble and check through the loaders a user calls
    testee = NVSRTestee(model_name="dnn", device=dev)
    testee.load_generator_checkpoint(gen_path)
    unmatched = testee.load_vocoder_checkpoint(voc_path, check=check)
    if unmatched:
        raise AssertionError(f"the exported vocoder left tensors unmatched: {unmatched}")
    rep = synthesis_report(testee.model)
    print(f"[check] vocoder sanity: {rep}", flush=True)

    report = {
        "vocoder_steps": vocoder_steps,
        "generator_steps": generator_steps,
        "vocoder_loss_first_last": [v_losses[0], v_losses[-1]],
        "generator_loss_first_last": [g_losses[0], g_losses[-1]],
        "vocoder_sanity": rep,
        "vocoder_steps_run": len(v_losses),
        "device": dev.type,
    }
    with open(os.path.join(out, "train_report.json"), "w") as f:
        json.dump(report, f, indent=1)
    return {
        "report": report,
        "paths": {"vocoder": voc_path, "generator": gen_path, "report": os.path.join(out, "train_report.json")},
        "vocoder_losses": v_losses,
        "generator_losses": g_losses,
        "probe_corr": corrs,
        "generator_variables": g_vars,
        "seconds": seconds,
        "testee": testee,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("vocoder_steps", nargs="?", type=int, default=400)
    ap.add_argument("generator_steps", nargs="?", type=int, default=300)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None,
                    help="default: the CUDA card (raises without one)")
    args = ap.parse_args(argv)
    res = train_small_nvsr(args.out, args.vocoder_steps, args.generator_steps, device=args.device)
    print(json.dumps({"vocoder_final_loss": res["vocoder_losses"][-1],
                      "generator_final_loss": res["generator_losses"][-1],
                      "sanity_corr": res["report"]["vocoder_sanity"]["corr"]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
