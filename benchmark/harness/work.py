"""Work one job needs, counted from the algorithm and the real lengths, and
the chip's published peaks.

Nothing here asks the program what it ran: padding rows, bucket padding and
frames past a file's end are not work the evaluation needs, so a program
that stops computing them reads as closer to its roofline, and one that
fuses or reorders its ops reads the same.

FLOP:
- FFT: 2.5 N log2 N per real transform of length N (per frame);
- resampling: 2 per tap, (2 * 10 * max(up, down) + 1) / up taps per output
  sample (scipy's resample_poly filter spread over its phases);
- the degradation: what each family's module under `benchmark/degrade/`
  counts (fft: one forward STFT per utterance and one inverse per spec);
- the testee: the configuration's `testee_flop_per_sample` per input-rate
  sample and spec;
- the metric |STFT| once per utterance for the target and once per spec for
  the estimate, and METRIC_FLOP_PER_BIN per (frame, bin) and spec for the
  four metrics (LSD 8, log-SiSpec 8, SiSpec 4, SSIM 40: five box means as
  integral images and the SSIM formula).

The |STFT| kernel's least time per call: its input (the reflect-padded
signal) read once and its output written once at HBM_BYTES_PER_S, against
its FLOP (2.5 N log2 N per frame plus 3 per bin for the magnitude) at
FP32_FLOP_PER_S, over real rows and real frames only.  Beside the metric
|STFT|s it counts the testee's own: a configuration's `testee_stft` lists
the |STFT| calls ({"n_fft", "hop"}) its testee makes per spec on the
input-rate signal.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, dense, at its 700 W power limit: float32
# outside the tensor cores, and HBM3 bandwidth.
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
METRIC_FLOP_PER_BIN = 60


def fft_flops(n: int) -> float:
    return 2.5 * n * math.log2(n) if n > 1 else 0.0


def _ratio(sr_in: int, sr_out: int) -> tuple[int, int]:
    g = math.gcd(sr_in, sr_out)
    return sr_out // g, sr_in // g


def resampled_length(n: int, sr_in: int, sr_out: int) -> int:
    up, down = _ratio(sr_in, sr_out)
    return -(-n * up // down)


def resample_flops(n_out: int, sr_in: int, sr_out: int) -> float:
    up, down = _ratio(sr_in, sr_out)
    if up == down:
        return 0.0
    return 2.0 * n_out * (2 * 10 * max(up, down) + 1) / up


def metric_stft(rate: int) -> tuple[int, int]:
    return int(2048 / (44100 / rate)), int(rate / 100)


def stft_call(n: int, n_fft: int, hop: int) -> dict:
    """Least-time inputs of one |STFT| row over n real samples."""
    frames = 1 + n // hop
    bins = n_fft // 2 + 1
    return {
        "flop": frames * (fft_flops(n_fft) + 3 * bins),
        "bytes": 4.0 * ((n + 2 * (n_fft // 2)) + frames * bins),
    }


def least_seconds(call: dict) -> float:
    return max(call["flop"] / FP32_FLOP_PER_S, call["bytes"] / HBM_BYTES_PER_S)


def job_work(lengths: list[int], native_sr: int, helper: dict, config: dict, families: list) -> dict:
    """-> {"flop": FLOP of one job, "stft_least_s": the |STFT| kernel's least
    seconds over the job} for files of `lengths` native samples; families:
    [(degradation family module, its settings)]."""
    sr_in, sr_out, sr_ev = helper["input_sr"], helper["output_sr"], helper["evaluation_sr"]
    S = sum(len(mod.spec_keys(s, sr_in)) for mod, s in families)
    n_fft, hop = metric_stft(sr_ev)
    flop = stft_least = 0.0
    for n in lengths:
        n_in = resampled_length(n, native_sr, sr_in)
        n_gt = resampled_length(n, native_sr, sr_ev)
        n_est = resampled_length(n_in, sr_out, sr_ev)
        n_m = min(n_est, n_gt)
        m_frames = 1 + n_m // hop
        target = stft_call(n_m, n_fft, hop)
        flop += resample_flops(n_in, native_sr, sr_in) + resample_flops(n_gt, native_sr, sr_ev)
        flop += sum(mod.flop(n_in, s, sr_in) for mod, s in families)
        flop += S * (config["testee_flop_per_sample"] * n_in + resample_flops(n_est, sr_out, sr_ev))
        flop += (1 + S) * target["flop"] + S * m_frames * (n_fft // 2 + 1) * METRIC_FLOP_PER_BIN
        stft_least += (1 + S) * least_seconds(target)
        stft_least += S * sum(least_seconds(stft_call(n_in, c["n_fft"], c["hop"]))
                              for c in config.get("testee_stft", ()))
    return {"flop": flop, "stft_least_s": stft_least}
