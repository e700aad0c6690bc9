"""One-command real-data verification runbook (counterpart of
``ssr_eval_tpu/verify_real.py``: the same CLI, stages and report JSON).

    python -m ssr_eval_tpu_torch.verify_real [--vctk PATH] [--ckpt PATH]
           [--vocoder-ckpt PATH] [--out report.json] [--batch-size N]
           [--device cpu]

The two parity targets that need data this repository does not hold run
the moment that data is on disk:

1. **2022 golden replication** — run the reference's README experiment
   (identity testee, FFT sweep, eval 48 kHz) on the real VCTK 8-speaker
   test set and compare every metric of `averaged.proc_fft_24000_44100`
   against the checked-in 2022 artifact
   (reference examples/results/2022-03-28-*.json, README.md:33-42).
2. **NVSR 0.84-AVG-LSD leaderboard row** — load the pretrained torch
   checkpoint (reference examples/NVSR/main.py:50-79), graft the
   voicefixer vocoder (with the load-time sanity check,
   models/vocoder_check.py), run the 7-cutoff sweep and compare each
   LSD column + the average against reference README.md:111.

Each stage reports SKIP with the command or URL it needs when its input
is missing; hard mismatches exit nonzero.  Unlike the JAX runbook this one
never downloads: a missing VCTK root and a missing checkpoint
(`models.testees.download_checkpoint` raises instead of fetching) are
SKIPs with their hints.  The stages run on `--device` (default: the CUDA
card; without one, and without `--device cpu`, the runbook raises).
Pinned values live in `harness/golden.py`.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.harness.golden import (
    GOLDEN_2022,
    GOLDEN_2022_TOL,
    NVSR_LEADERBOARD_AVG,
    NVSR_LEADERBOARD_LSD,
    NVSR_LEADERBOARD_TOL,
)

_VCTK_HINT = (
    "download the VCTK test tar (reference eval.py:102-119; "
    "https://zenodo.org/record/6228351) and pass --vctk <extracted root "
    "containing p360..s5>, or set SSR_EVAL_VCTK_ROOT"
)
_CKPT_HINT = (
    "download the pretrained NVSR checkpoint (reference "
    "examples/NVSR/main.py:50-79, Zenodo) and pass --ckpt <pth>; the "
    "voicefixer vocoder state dict goes to --vocoder-ckpt <pth>"
)


def _resolve_vctk(arg):
    """-> (root or None, detail).  Never downloads."""
    root = arg or os.environ.get("SSR_EVAL_VCTK_ROOT")
    if root and os.path.isdir(os.path.join(root, "s5")):
        return root, f"real VCTK at {root}"
    if root:
        return None, f"{root} exists but has no s5/ speaker dir; {_VCTK_HINT}"
    default = os.path.join("datasets", "vctk_test")
    if os.path.isdir(os.path.join(default, "s5")):
        return default, f"real VCTK at {default}"
    return None, f"no VCTK test set (this package does not download it); {_VCTK_HINT}"


def run_golden(vctk_root, batch_size=8, device=None):
    """Stage 1: replicate the 2022 unprocessed-identity artifact."""
    from ssr_eval_tpu_torch.harness.smoke import test as smoke_test

    result = smoke_test(
        test_data_root=vctk_root, auto_download=False, batch_size=batch_size, device=device
    )
    got = result["averaged"]["proc_fft_24000_44100"]
    rows = []
    ok = True
    for k, ref in GOLDEN_2022.items():
        delta = abs(got[k] - ref)
        good = delta < GOLDEN_2022_TOL[k]
        ok &= good
        rows.append(
            {"metric": k, "got": got[k], "golden": ref, "abs_delta": delta,
             "tol": GOLDEN_2022_TOL[k], "pass": good}
        )
    return ok, rows


def run_nvsr(vctk_root, ckpt, vocoder_ckpt, batch_size=8, device=None):
    """Stage 2: the leaderboard row.  Cutoffs are HALF the proc-key rates
    (the ctor doubles them, reference eval.py:121-126)."""
    from ssr_eval_tpu_torch.harness.helper import SSR_Eval_Helper
    from ssr_eval_tpu_torch.models.testees import NVSRPostProcTestee

    testee = NVSRPostProcTestee(model_name="unet", ckpt=ckpt, device=device)
    if vocoder_ckpt is not None:
        unmatched = testee.load_vocoder_checkpoint(vocoder_ckpt)  # check=True
        if unmatched:
            print(f"[verify_real] vocoder: {len(unmatched)} unmatched "
                  f"tensors: {unmatched[:5]} ...")
    helper = SSR_Eval_Helper(
        testee,
        test_name="NVSR_verify",
        input_sr=44100, output_sr=44100, evaluation_sr=44100,
        test_data_root=vctk_root, auto_download=False,
        setting_fft={
            "cutoff_freq": [int(k.split("_")[2]) // 2
                            for k in NVSR_LEADERBOARD_LSD],
        },
        save_processed_result=False,
        batch_size=batch_size,
        device=device,
    )
    result = helper.evaluate(limit_test_nums=-1, limit_test_speaker=-1)
    rows = []
    ok = True
    lsds = []
    for key, ref in NVSR_LEADERBOARD_LSD.items():
        got = result["averaged"][key]["lsd"]
        lsds.append(got)
        delta = abs(got - ref)
        good = delta < NVSR_LEADERBOARD_TOL
        ok &= good
        rows.append(
            {"key": key, "lsd": got, "leaderboard": ref, "abs_delta": delta,
             "tol": NVSR_LEADERBOARD_TOL, "pass": good}
        )
    avg = sum(lsds) / len(lsds)
    good = abs(avg - NVSR_LEADERBOARD_AVG) < NVSR_LEADERBOARD_TOL
    ok &= good
    rows.append(
        {"key": "AVG", "lsd": avg, "leaderboard": NVSR_LEADERBOARD_AVG,
         "abs_delta": abs(avg - NVSR_LEADERBOARD_AVG),
         "tol": NVSR_LEADERBOARD_TOL, "pass": good}
    )
    return ok, rows


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m ssr_eval_tpu_torch.verify_real",
        description="Verify the framework against the reference's two "
        "real-data targets (2022 golden artifact + NVSR leaderboard row).",
    )
    ap.add_argument("--vctk", help="real VCTK test-set root (contains s5/)")
    ap.add_argument("--ckpt", help="pretrained NVSR torch checkpoint (.pth)")
    ap.add_argument("--vocoder-ckpt",
                    help="voicefixer vocoder state dict (.pth)")
    ap.add_argument("--out", default="verify_real_report.json",
                    help="JSON report path (default %(default)s)")
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--skip-golden", action="store_true")
    ap.add_argument("--skip-nvsr", action="store_true")
    ap.add_argument("--device", help="'cpu' for the plain PyTorch path (default: the CUDA card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    report = {"stages": {}}
    failed = False

    vctk_root, vctk_detail = _resolve_vctk(args.vctk)
    print(f"[verify_real] dataset: {vctk_detail}")

    # -- stage 1: golden replication ----------------------------------
    if args.skip_golden:
        report["stages"]["golden_2022"] = {"status": "SKIP",
                                           "detail": "--skip-golden"}
    elif vctk_root is None:
        report["stages"]["golden_2022"] = {"status": "SKIP",
                                           "detail": vctk_detail}
    else:
        ok, rows = run_golden(vctk_root, args.batch_size, device)
        report["stages"]["golden_2022"] = {
            "status": "PASS" if ok else "FAIL", "rows": rows,
        }
        failed |= not ok

    # -- stage 2: NVSR leaderboard row --------------------------------
    ckpt = args.ckpt
    if ckpt is None:
        from ssr_eval_tpu_torch.models.testees import download_checkpoint

        try:
            ckpt = download_checkpoint()
        except RuntimeError as e:  # not on disk: this package never fetches it
            ckpt_detail = f"checkpoint unavailable ({e}); {_CKPT_HINT}"
    if args.skip_nvsr:
        report["stages"]["nvsr_leaderboard"] = {"status": "SKIP",
                                                "detail": "--skip-nvsr"}
    elif vctk_root is None:
        report["stages"]["nvsr_leaderboard"] = {"status": "SKIP",
                                                "detail": vctk_detail}
    elif ckpt is None:
        report["stages"]["nvsr_leaderboard"] = {"status": "SKIP",
                                                "detail": ckpt_detail}
    else:
        if args.vocoder_ckpt is None:
            print("[verify_real] note: no --vocoder-ckpt; the grafted "
                  "vocoder stays at its converted/if-bundled state")
        ok, rows = run_nvsr(vctk_root, ckpt, args.vocoder_ckpt,
                            args.batch_size, device)
        report["stages"]["nvsr_leaderboard"] = {
            "status": "PASS" if ok else "FAIL", "rows": rows,
        }
        failed |= not ok

    # -- summary -------------------------------------------------------
    print()
    for name, st in report["stages"].items():
        line = f"[verify_real] {name}: {st['status']}"
        if st["status"] == "SKIP":
            line += f" — {st['detail']}"
        print(line)
        for r in st.get("rows", []):
            label = r.get("metric") or r.get("key")
            print(f"    {label:28s} got={r.get('got', r.get('lsd')):10.4f} "
                  f"ref={r.get('golden', r.get('leaderboard')):10.4f} "
                  f"|d|={r['abs_delta']:.2e} tol={r['tol']:g} "
                  f"{'ok' if r['pass'] else 'MISMATCH'}")
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"[verify_real] report -> {args.out}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
