"""The comparison that decides `correct`.

Each job's return value from `evaluate()` is judged against the plain
reference:

- per file and spec: |program - reference| of SiSpec (dB) and SSIM;
- per spec: |program - reference| of the mean LSD and the mean log-SiSpec
  (dB) over the job's files, as `averaged` reports them.  A single file's
  LSD and log-SiSpec are not compared: both take the log of every bin of
  the estimate's |STFT|, and where a real-valued bin (DC, Nyquist) of the
  noisy estimate falls near zero by chance, float32 rounding alone moves
  that file's value by up to ~1e-3, as far as TF32 does (PERF.md);
- the aggregation: `each_speaker` and `averaged` against the means of the
  job's own per-file values, relative to max(1, |value|);
- the structure: every expected file, spec and metric present.

A job fails when a number passes its limit or the structure is wrong.  The
numbers reported are the largest over every compared job.
"""

from __future__ import annotations

import numpy as np

METRICS = ("lsd", "log_sispec", "sispec", "ssim")
NUMBERS = ("lsd_mean", "log_sispec_mean", "sispec_db", "ssim", "aggregate")


def per_file_gaps(got: dict, ref: dict) -> dict:
    """got / ref: {spec key: {metric: value}} of one file -> largest gaps."""
    return {
        "sispec_db": max(abs(got[k]["sispec"] - r["sispec"]) for k, r in ref.items()),
        "ssim": max(abs(got[k]["ssim"] - r["ssim"]) for k, r in ref.items()),
    }


def mean_gaps(got: dict, ref: dict) -> dict:
    """got / ref: `averaged` blocks -> largest gaps of the mean LSD and
    log-SiSpec over the specs."""
    return {
        "lsd_mean": max(abs(got[k]["lsd"] - r["lsd"]) for k, r in ref.items()),
        "log_sispec_mean": max(abs(got[k]["log_sispec"] - r["log_sispec"]) for k, r in ref.items()),
    }


def aggregate_gap(result: dict, speakers: list) -> float:
    """Largest gap of `each_speaker` / `averaged` from the means of the
    job's own per-file values (the reference's dict_mean reduction)."""
    gap = 0.0
    per_spk = {}
    for spk in speakers:
        files = list(result[spk].values())
        keys = list(files[0].keys())
        per_spk[spk] = {k: {m: float(np.mean([f[k][m] for f in files])) for m in METRICS} for k in keys}
        for k in keys:
            for m in METRICS:
                want = per_spk[spk][k][m]
                gap = max(gap, abs(result["each_speaker"][spk][k][m] - want) / max(1.0, abs(want)))
    for k in per_spk[speakers[-1]]:
        for m in METRICS:
            want = float(np.mean([per_spk[s][k][m] for s in speakers]))
            gap = max(gap, abs(result["averaged"][k][m] - want) / max(1.0, abs(want)))
    return gap


def judge(result: dict, reference: dict, ref_averaged: dict, speakers: list, n_files: int, keys: list,
          limits: dict):
    """-> (numbers of this job, None or the reason it failed).

    reference: {(speaker, file name): {spec key: {metric: value}}};
    ref_averaged: its `averaged` block."""
    numbers = dict.fromkeys(NUMBERS, 0.0)
    try:
        for spk in speakers:
            if len(result[spk]) != n_files:
                return numbers, f"{spk}: {len(result[spk])} files, expected {n_files}"
            for name, per in result[spk].items():
                if sorted(per) != sorted(keys) or any(sorted(v) != sorted(METRICS) for v in per.values()):
                    return numbers, f"{spk}/{name}: keys {sorted(per)}"
        for (spk, name), ref in reference.items():
            for k, v in per_file_gaps(result[spk][name], ref).items():
                numbers[k] = max(numbers[k], v)
        numbers.update(mean_gaps(result["averaged"], ref_averaged))
        numbers["aggregate"] = aggregate_gap(result, speakers)
    except (KeyError, TypeError, IndexError, StopIteration) as e:
        return numbers, f"malformed result: {type(e).__name__}: {e}"
    bad = [k for k in NUMBERS if not numbers[k] <= limits[k]]
    return numbers, (f"over the limit: {', '.join(bad)}" if bad else None)
