"""Multi-system leaderboard regeneration (counterpart of
``ssr_eval_tpu/harness/leaderboard.py``).

The reference publishes its leaderboard as a hand-maintained README table
(reference README.md:107-120: per-system LSD at each input bandwidth plus
the AVG column).  Here the table is generated: run any number of named
testees through one shared sweep and emit the markdown.

    from ssr_eval_tpu_torch.harness.leaderboard import run_leaderboard
    rows, table = run_leaderboard(
        {"Unprocessed": BasicTestee(), "NVSR": NVSRTestee(...)},
        test_data_root=..., cutoffs_khz=[1, 2, 4, 6, 8, 12],
    )

Each system is evaluated with the same SSR_Eval_Helper configuration
(44.1 kHz in/out/eval, FFT-mask degradation — the leaderboard's setting)
on `device` (None is the CUDA card, "cpu" the CPU).  Per batch a device
testee launches the |STFT| kernel 1 + len(cutoffs) times (the target once,
each estimate once); a host testee (`BasicTestee.infer`) is scored per
spec against its own target, 2 per cutoff.
"""

from __future__ import annotations

import numpy as np

from ssr_eval_tpu_torch.harness.helper import SSR_Eval_Helper


def run_leaderboard(
    testees: dict,
    test_data_root: str,
    cutoffs_khz=(1, 2, 4, 6, 8, 12),
    input_sr=44100,
    output_sr=44100,
    evaluation_sr=44100,
    metric="lsd",
    limit_test_nums=-1,
    limit_test_speaker=-1,
    mesh=None,
    batch_size=8,
    auto_download=False,
    device=None,
):
    """-> (rows dict, markdown str).

    rows[name] = {cutoff_khz: metric_value, "AVG": mean} — the reference
    README's leaderboard layout (input bandwidth columns + AVG).
    """
    cutoff_hz = [int(k * 1000) for k in cutoffs_khz]
    rows = {}
    for name, testee in testees.items():
        helper = SSR_Eval_Helper(
            testee,
            input_sr=input_sr,
            output_sr=output_sr,
            evaluation_sr=evaluation_sr,
            test_name=f"leaderboard_{name}",
            test_data_root=test_data_root,
            setting_fft={"cutoff_freq": list(cutoff_hz)},
            auto_download=auto_download,
            mesh=mesh,
            batch_size=batch_size,
            device=device,
        )
        result = helper.evaluate(
            limit_test_nums=limit_test_nums,
            limit_test_speaker=limit_test_speaker,
            verbose=False,
        )
        row = {}
        for c in cutoff_hz:
            key = f"proc_fft_{2 * c}_{input_sr}"
            row[c // 1000] = float(result["averaged"][key][metric])
        row["AVG"] = float(np.mean([row[c // 1000] for c in cutoff_hz]))
        rows[name] = row

    md = _to_markdown(rows, cutoffs_khz, metric)
    return rows, md


def _to_markdown(rows, cutoffs_khz, metric):
    header = (
        "| Model | "
        + " | ".join(f"{k} kHz" for k in cutoffs_khz)
        + f" | AVG ({metric}) |"
    )
    sep = "|" + "---|" * (len(cutoffs_khz) + 2)
    lines = [header, sep]
    for name, row in sorted(rows.items(), key=lambda kv: kv[1]["AVG"]):
        cells = " | ".join(f"{row[k]:.2f}" for k in cutoffs_khz)
        lines.append(f"| {name} | {cells} | {row['AVG']:.2f} |")
    return "\n".join(lines)
