"""Benchmark of the port: utterance-evaluation throughput on the VCTK LSD
sweep on one CUDA card (the counterpart of the repository's ``bench.py``).

    python -m ssr_eval_tpu_torch.bench [--detail PATH]

Runs the evaluation pipeline (decode -> degrade (fft sweep) -> testee ->
metrics x4) through the port's engine and compares it with a float64
NumPy implementation of the reference pipeline, timed on this host's CPU in
the same run (what upstream ssr_eval does through librosa / scipy on the
CPU, without its sox subprocess per file).  Sections of the detail:

- headline: the identity testee over N_UTTS speech-like 6 s utterances at
  44.1 kHz, cutoffs 1-16 kHz, batch 16: best of PASSES warm passes, the
  best pass's disjoint stage seconds (decode / dispatch / drain), the
  |STFT| kernel's launches over the timed passes, and utilization from
  ``utils.flops`` (FLOP and bytes of the engine's batch program x the
  calls per second, against the card's fp32 and bf16 peaks).
- headline_drain_split: one synchronised call of the engine's recorded
  batch program against K back-to-back calls on card-resident inputs.
- baseline: the float64 pipeline on N_BASE utterances, best of 2, on
  this host's CPU; vs_baseline is the headline's utt/s over it.
- accuracy: the identity testee's deltas from the float64 oracle (read
  at the masked bands' rounding floor: reported only), a well-conditioned
  (broadband-noise) testee against the oracle in all four metrics, and the
  engine's metrics_backend="host_float64" on the same sweep.
- nvsr: NVSRTestee("unet") with seeded random weights, bf16 and fp32.
- iir_subsampling_matrix and mp3 (when the host has a codec).
- kernel_ab: the |STFT| kernel at [8, 266240] (2048/441, 604 frames)
  against its plain version and torch.stft(...).abs(), a yardstick the
  port never calls, with CUDA events.

The last stdout line is one compact JSON object (under 2 KB) with the keys
``metric``, ``value``, ``unit``, ``vs_baseline``, ``detail`` and
``detail_file``; the full detail goes to ``--detail`` (default
bench_torch_detail.json in the working directory).  Logs go to stderr as
"[bench] ...".

Environment: SSR_BENCH_QUICK=1 runs tiny shapes that check the machinery
(its numbers mean nothing); SSR_BENCH_NVSR=0 leaves the NVSR section out;
SSR_BENCH_CPU=1 runs on the CPU (device "cpu").  Without a CUDA card and
without SSR_BENCH_CPU it exits non-zero.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import platform
import subprocess
import sys
import tempfile
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch

from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel
from ssr_eval_tpu_torch.harness.engine import METRIC_KEYS, EvalEngine
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.harness.testee import BatchedTestee
from ssr_eval_tpu_torch.io.audio import decode_audio, write_wav
from ssr_eval_tpu_torch.metrics.host_reference import istft_np, spectral_metrics_np, stft_np
from ssr_eval_tpu_torch.utils.flops import (
    chip_peaks,
    engine_program_costs,
    materialize,
    stft_magnitude_cost,
    utilization,
)

SR = 44100
NOISE_SEED = 777
# The kernel A/B: 8 buffers of 266,240 samples (a 6 s utterance's 264,600
# in its bucket) at the metric STFT 2048/441 -> 604 frames; R calls per
# timing.
AB_ROWS, AB_LEN, AB_NFFT, AB_HOP, AB_R = 8, 266240, 2048, 441, 10
# The mixed-family matrix (cutoffs already doubled, as the engine takes
# them): two IIR designs at 4 and 8 kHz and 4 kHz subsampling.
MATRIX = dict(
    setting_lowpass_filtering={"filter": ["cheby", "butter"], "cutoff_freq": [8000, 16000], "filter_order": [8]},
    setting_subsampling={"cutoff_freq": [8000]},
)
MP3_KBPS, MP3_UTTS, MP3_BATCH = 32, 16, 8


class Sizes(NamedTuple):
    n_utts: int = 192
    utt_seconds: float = 6.0
    batch: int = 16
    passes: int = 5
    n_base: int = 6  # the CPU baseline's and the accuracy sweeps' utterances
    cutoffs: tuple = (1000, 2000, 4000, 6000, 8000, 12000, 16000)  # input rates 2-32 kHz
    n_nvsr: int = 32
    nvsr_batch_bf16: int = 16
    nvsr_batch_f32: int = 8
    drain_k: int = 12  # back-to-back calls of the drain split


FULL = Sizes()
QUICK = Sizes(n_utts=8, utt_seconds=2.0, batch=4, passes=2, n_base=2, cutoffs=(2000, 8000), n_nvsr=4,
              nvsr_batch_bf16=2, nvsr_batch_f32=2, drain_k=3)


def _flag(name: str, default: str) -> bool:
    """"0", "false" and "" mean off."""
    return os.environ.get(name, default) not in ("0", "false", "")


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def _error(e: Exception) -> dict:
    _log(traceback.format_exc())
    return {"error": f"{type(e).__name__}: {e}"[:200]}


# ----------------------------------------------------------------------
# Data, testees, oracle
# ----------------------------------------------------------------------


def make_dataset(root, n, seconds):
    """n speech-like utterances (`speechlike` seeds 1000 + i) as 16-bit WAV
    files root/utt_{i:03d}.wav -> their paths, in order (written by 8
    threads: numpy's sin releases the interpreter lock)."""

    def one(i):
        p = os.path.join(root, f"utt_{i:03d}.wav")
        write_wav(p, speechlike(seconds, SR, seed=1000 + i), SR)
        return p

    with ThreadPoolExecutor(8) as ex:
        return list(ex.map(one, range(n)))


def make_noise() -> np.ndarray:
    """The well-conditioned testee's broadband floor: 1e-3 N(0, 1), 2^17
    samples, seed 777."""
    return (1e-3 * np.random.default_rng(NOISE_SEED).standard_normal(1 << 17)).astype(np.float32)


class NoisyTestee(BatchedTestee):
    """Broadband-floor testee: adds a fixed noise (its device state) to its
    input, so estimated spectra sit far above any float32 rounding floor
    and deltas against the float64 oracle measure the pipeline (PARITY.md
    deviation 4)."""

    def __init__(self, noise):
        self.noise = noise

    def device_state(self):
        return self.noise

    def infer_batch(self, x, lengths, state=None):
        ar = torch.arange(x.shape[1], device=x.device)
        mask = (ar[None, :] < lengths[:, None]).to(torch.float32)
        return x.to(torch.float32) + state[ar % state.shape[0]][None, :] * mask, lengths


def f64_pipeline_one(path, cutoffs, noise=None) -> dict:
    """The reference fft sweep for one utterance in float64: {key: the four
    metrics}; `noise` is added to every estimate as NoisyTestee adds it."""
    x = decode_audio(path)[0].astype(np.float64)
    hop, n_fft = int(SR / 100), int(2048 / (44100 / SR))
    tgt_sp = np.abs(stft_np(x, n_fft, hop)).T
    out = {}
    for c in cutoffs:
        Z = stft_np(x, 2048, 441)
        Z[int(1025 * (c / int(SR / 2))) :, :] = 0.0
        est = istft_np(Z, 2048, 441, length=len(x))
        if noise is not None:
            est = est + noise.astype(np.float64)[np.arange(len(est)) % noise.shape[0]]
        out[f"proc_fft_{2 * c}_{SR}"] = spectral_metrics_np(np.abs(stft_np(est, n_fft, hop)).T, tgt_sp)
    return out


def engine(specs, testee, batch, device, **kw):
    return EvalEngine(specs, SR, SR, SR, testee, batch_size=batch, device=device, **kw)


# ----------------------------------------------------------------------
# Timing and accounting
# ----------------------------------------------------------------------


def _best_of(n, fn):
    """-> (the least seconds of n calls of fn, the last call's result)."""
    best, out = math.inf, None
    for _ in range(n):
        t0 = time.perf_counter()
        out = fn()
        best = min(best, time.perf_counter() - t0)
    return best, out


class Passes(NamedTuple):
    best_s: float
    stages: dict  # the best pass's stage seconds
    runs: list
    launches: int  # |STFT| kernel launches over the timed passes


def timed_passes(eng, paths, passes) -> Passes:
    """Warm once (one batch, then the whole set: allocator, cuFFT and cuDNN
    plans, constants), then `passes` timed passes."""
    eng.evaluate_files(paths[: eng.batch_size])
    eng.evaluate_files(paths)
    l0 = stft_magnitude_kernel.launches
    best, best_stages, runs = None, None, []
    for _ in range(passes):
        before = dict(eng.stats.seconds)
        t0 = time.perf_counter()
        eng.evaluate_files(paths)
        dt = time.perf_counter() - t0
        runs.append(round(dt, 4))
        if best is None or dt < best:
            best = dt
            best_stages = {k: round(v - before.get(k, 0.0), 4) for k, v in eng.stats.seconds.items()
                           if "." not in k}  # the stages, without the spans nested in them
    return Passes(best, best_stages, runs, stft_magnitude_kernel.launches - l0)


def fused_cost(eng) -> dict:
    """FLOP and bytes of the engine's one batch program (utils.flops; runs
    it once more on inputs of its recorded shapes)."""
    fused = [c for label, c in engine_program_costs(eng).items() if label.startswith("fused")]
    if len(fused) != 1:
        raise ValueError(f"{len(fused)} fused batch programs (expected 1)")
    return fused[0]


def utilization_of(cost, n_utts, batch, elapsed_s, peaks) -> dict:
    """TFLOP/s, GB/s and their shares of the peaks for one pass of
    ceil(n_utts / batch) calls of the program in `elapsed_s`."""
    calls = -(-n_utts // batch)
    u = utilization(cost["flops"] * calls, cost["bytes_accessed"] * calls, 1.0 / elapsed_s, peaks)
    u["flops_per_utt"] = round(cost["flops"] / batch)
    u["bytes_per_utt"] = round(cost["bytes_accessed"] / batch)
    return u


def drain_split(eng, peaks, cost, k, peak="fp32_tflops") -> dict:
    """One synchronised call of the engine's batch program against k
    back-to-back calls, on card-resident inputs of its recorded shapes.

    marginal = (t_k - t_1) / (k - 1) is the steady-state cost per call; in
    eager PyTorch it is the larger of the host's time to launch the call's
    kernels and the card's time to run them.  The roofline ms is the
    program's bytes at the HBM rate or its FLOP at `peak` (the peak of its
    compute dtype: fp32 for the DSP, bf16 for a bf16 model), whichever is
    longer."""
    ((fn, specs),) = [v for key, v in eng._cost_args.items() if key[0] == "fused"]
    args = materialize(specs, eng.device)

    def force(out):
        (out[0] if isinstance(out, tuple) else out).cpu()  # the last call waits for all

    force(fn(*args))  # warm
    t1, _ = _best_of(3, lambda: force(fn(*args)))
    tk, _ = _best_of(2, lambda: force([fn(*args) for _ in range(k)][-1]))
    ideal_ms = None
    if peaks.get("hbm_gbps") and peaks.get(peak):
        ideal_ms = 1e3 * max(cost["bytes_accessed"] / (peaks["hbm_gbps"] * 1e9), cost["flops"] / (peaks[peak] * 1e12))
    return {
        "one_call_ms": round(t1 * 1e3, 3),
        "pipelined_marginal_ms_per_call": round((tk - t1) / (k - 1) * 1e3, 3),
        "roofline_ideal_ms_per_call": None if ideal_ms is None else round(ideal_ms, 3),
        "k": k,
        "roofline_flop_peak": peak,
        "note": (
            "device-resident inputs; eager PyTorch launches each op from the host, so the pipelined "
            "marginal is the larger of host launch time and device time per call, and one_call - "
            "marginal is the synchronisation latency that back-to-back calls hide; the roofline is "
            "utils.flops.count_cost's unfused bytes at the HBM rate or FLOP at roofline_flop_peak"
        ),
    }


def _cuda_ms(fn):
    """ms per call of fn over AB_R back-to-back calls, best of 3 (CUDA
    events, after a warm call)."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    best = None
    for _ in range(3):
        start.record()
        for _ in range(AB_R):
            fn()
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / AB_R
        best = ms if best is None else min(best, ms)
    return best


def kernel_ab(device, peaks) -> dict:
    """The |STFT| kernel at [AB_ROWS, AB_LEN] 2048/441: ms per call of the
    kernel, its plain version and torch.stft(...).abs(); the bound; max
    |kernel - plain| of max |plain|."""
    from ssr_eval_tpu_torch.dsp.spectral import window_tensor
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_plain

    ext_len = AB_LEN + 2 * (AB_NFFT // 2)
    mf = 1 + (ext_len - AB_NFFT) // AB_HOP
    g = torch.Generator(device=device).manual_seed(0)
    ext = torch.randn(AB_ROWS, ext_len, generator=g, device=device)
    win = window_tensor(AB_NFFT, AB_NFFT, device)
    got = stft_magnitude_kernel(ext, AB_NFFT, AB_HOP, mf, win)
    want = stft_magnitude_plain(ext, AB_NFFT, AB_HOP, mf, win)
    err = ((got - want).abs().max() / want.abs().max()).item()
    flops, nbytes = stft_magnitude_cost(AB_ROWS, ext_len, mf, AB_NFFT)
    bound = {"bound_ms": None, "bound_by": None}  # an unknown card has no peaks
    if peaks.get("hbm_gbps") and peaks.get("fp32_tflops"):
        t_bytes = nbytes / (peaks["hbm_gbps"] * 1e9) * 1e3
        t_ops = flops / (peaks["fp32_tflops"] * 1e12) * 1e3
        bound = {"bound_ms": round(max(t_bytes, t_ops), 4), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    return {
        "shape": [AB_ROWS, AB_LEN], "ext_len": ext_len, "n_fft": AB_NFFT, "hop": AB_HOP, "frames": mf,
        "calls_per_timing": AB_R,
        "kernel_ms": round(_cuda_ms(lambda: stft_magnitude_kernel(ext, AB_NFFT, AB_HOP, mf, win)), 4),
        "plain_ms": round(_cuda_ms(lambda: stft_magnitude_plain(ext, AB_NFFT, AB_HOP, mf, win)), 4),
        "torch_stft_abs_ms": round(_cuda_ms(
            lambda: torch.stft(ext, AB_NFFT, AB_HOP, window=win, center=False, return_complex=True).abs()
        ), 4),
        **bound,
        "bytes": nbytes,
        "fft_flops": flops,
        "max_abs_err_of_max": err,
    }


# ----------------------------------------------------------------------
# Sections
# ----------------------------------------------------------------------


def _free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def nvsr_section(specs, paths, device, sz, peaks) -> dict:
    """NVSRTestee("unet") (seeded random weights) over `specs` on sz.n_nvsr
    utterances: bf16 at sz.nvsr_batch_bf16 with its drain split, fp32 at
    sz.nvsr_batch_f32; warm-up, then the best of 2 passes."""
    from ssr_eval_tpu_torch.models import testees

    n_nv = sz.n_nvsr

    def run(dtype, batch):
        eng = engine(specs, testees.NVSRTestee(model_name="unet", dtype=dtype, device=device), batch, device)
        eng.evaluate_files(paths[:batch])
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        l0 = stft_magnitude_kernel.launches
        best, res = _best_of(2, lambda: eng.evaluate_files(paths[:n_nv]))
        launches = stft_magnitude_kernel.launches - l0
        per_cut = {}
        for p in paths[:n_nv]:
            for key, m in res[p].items():
                per_cut.setdefault(key, []).append(float(m["lsd"]))
        cost = fused_cost(eng)
        util = utilization_of(cost, n_nv, batch, best, peaks)
        if device.type == "cuda":
            util["max_memory_allocated_gib"] = round(torch.cuda.max_memory_allocated(device) / 2**30, 3)
        if dtype is torch.bfloat16:  # the benched default's per-batch cost
            util["drain_split"] = drain_split(eng, peaks, cost, sz.drain_k, peak="bf16_tflops")
        del eng
        _free(device)
        return round(n_nv / best, 3), {k: float(np.mean(v)) for k, v in per_cut.items()}, util, launches

    thr_bf16, lsd_bf16, util_bf16, l_bf16 = run(torch.bfloat16, sz.nvsr_batch_bf16)
    thr_f32, lsd_f32, util_f32, l_f32 = run(None, sz.nvsr_batch_f32)
    return {
        "n_utts": n_nv,
        "batch_bf16": sz.nvsr_batch_bf16,
        "batch_f32": sz.nvsr_batch_f32,
        "utt_per_s_per_chip_bf16": thr_bf16,
        "utt_per_s_per_chip_f32": thr_f32,
        "utilization_bf16": util_bf16,
        "utilization_f32": util_f32,
        "stft_launches_bf16": l_bf16,
        "stft_launches_f32": l_f32,
        "max_abs_dLSD_bf16_vs_f32": round(max(abs(lsd_f32[k] - lsd_bf16[k]) for k in lsd_f32), 6),
        "weights": "seeded random init (seed 234; no pretrained checkpoint in the repository)",
        "lsd_per_cutoff": {k: round(v, 3) for k, v in lsd_f32.items()},
    }


def matrix_section(paths, device, sz) -> dict:
    mixed = expand_settings(**MATRIX, sr=SR)
    r = timed_passes(engine(mixed, BatchedTestee(), sz.batch, device), paths[: sz.n_utts // 2], passes=2)
    return {"n_specs": len(mixed), "n_utts": sz.n_utts // 2,
            "utt_per_s_per_chip": round((sz.n_utts // 2) / r.best_s, 3),
            "elapsed_s_best": round(r.best_s, 4), "stage_seconds_best_pass": r.stages, "stft_launches": r.launches}


def mp3_section(paths, device, sz) -> dict:
    from ssr_eval_tpu_torch.degrade.codec import detect_backend

    backend = detect_backend()
    if backend is None:
        return {"skipped": "no codec available (libmp3lame, sox or ffmpeg)"}
    _log(f"mp3 family ({backend})")
    specs = expand_settings(setting_mp3_compression={"low_kbps": [MP3_KBPS]}, sr=SR)
    batch, n = min(MP3_BATCH, sz.n_utts), min(MP3_UTTS, sz.n_utts)
    eng = engine(specs, BatchedTestee(), batch, device)
    eng.evaluate_files(paths[:batch])
    best, _ = _best_of(2, lambda: eng.evaluate_files(paths[:n]))
    return {"backend": backend, "n_utts": n, "batch": batch, "utt_per_s_per_chip": round(n / best, 3),
            "note": "codec-bound: the engine runs codec jobs on a host thread pool (codec_wait stage) "
                    "against device work"}


def card_line():
    """The card's name and power limit as nvidia-smi prints them, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return None
    return r.stdout.strip().splitlines()[0]


def host_cpu() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def run(sz: Sizes, device, tmp, nvsr=True) -> tuple[dict, dict]:
    """Every section on `device` with data under `tmp` -> (the full detail,
    the compact last line)."""
    paths = make_dataset(tmp, sz.n_utts, sz.utt_seconds)
    specs = expand_settings(setting_fft={"cutoff_freq": [2 * c for c in sz.cutoffs]}, sr=SR)
    peaks = chip_peaks(device)
    base_paths = paths[: sz.n_base]

    # ---- headline: identity testee, full sweep --------------------------
    _log(f"headline: {sz.n_utts} utts x {len(sz.cutoffs)} cutoffs, batch {sz.batch}, best of {sz.passes}")
    eng = engine(specs, BatchedTestee(), sz.batch, device)
    head = timed_passes(eng, paths, sz.passes)
    thr = sz.n_utts / head.best_s
    cost = fused_cost(eng)
    headline_util = utilization_of(cost, sz.n_utts, sz.batch, head.best_s, peaks)
    _log("headline drain split (1 vs K back-to-back calls)")
    drain = drain_split(eng, peaks, cost, sz.drain_k)
    results = eng.evaluate_files(base_paths)  # for the identity testee's oracle deltas

    # ---- CPU reference baseline (float64 NumPy, same sweep) -------------
    _log(f"cpu baseline: the float64 pipeline on {sz.n_base} utts, best of 2")
    base_best, oracle = _best_of(2, lambda: {p: f64_pipeline_one(p, sz.cutoffs) for p in base_paths})
    base_utt_per_s = sz.n_base / base_best
    per_key_dlsd_id = {}
    for p in base_paths:
        for key, ref in oracle[p].items():
            d = abs(results[p][key]["lsd"] - ref["lsd"])
            per_key_dlsd_id[key] = round(max(per_key_dlsd_id.get(key, 0.0), d), 4)

    # ---- accuracy: well-conditioned testee, all four metrics -------------
    _log("accuracy: well-conditioned sweep against the float64 oracle")
    noise = make_noise()
    noisy = NoisyTestee(noise)
    r_wc = engine(specs, noisy, sz.n_base, device).evaluate_files(base_paths)
    per_key_delta_wc = {}
    for p in base_paths:
        ref = f64_pipeline_one(p, sz.cutoffs, noise=noise)
        for key in ref:
            slot = per_key_delta_wc.setdefault(key, dict.fromkeys(METRIC_KEYS, 0.0))
            for m in METRIC_KEYS:
                slot[m] = round(max(slot[m], abs(r_wc[p][key][m] - ref[key][m])), 7)
    max_delta_wc = {m: max(v[m] for v in per_key_delta_wc.values()) for m in METRIC_KEYS}
    _log("accuracy: host_float64 cross-check")
    r_h64 = engine(specs, noisy, sz.n_base, device, metrics_backend="host_float64").evaluate_files(base_paths)
    dev_vs_h64 = {m: round(max(abs(r_wc[p][k][m] - r_h64[p][k][m]) for p in base_paths for k in r_h64[p]), 7)
                  for m in METRIC_KEYS}

    # ---- NVSR (random weights), bf16 and fp32 ----------------------------
    nvsr_detail = {"skipped": "SSR_BENCH_NVSR=0"}
    if nvsr:
        _log("nvsr: NVSRTestee('unet'), bf16 then fp32")
        try:
            nvsr_detail = nvsr_section(specs, paths, device, sz, peaks)
        except Exception as e:  # recorded; the headline stands
            nvsr_detail = _error(e)
        _free(device)

    _log("iir/subsampling matrix")
    iir_detail = matrix_section(paths, device, sz)
    try:
        mp3_detail = mp3_section(paths, device, sz)
    except Exception as e:  # recorded; the headline stands
        mp3_detail = _error(e)

    if device.type != "cuda":
        ab = {"skipped": "the kernel runs only on a CUDA card"}
    else:
        _log("kernel A/B")
        ab = kernel_ab(device, peaks)

    vs_baseline = thr / base_utt_per_s
    card = card_line() if device.type == "cuda" else None
    cpu = host_cpu()
    stage_sum = round(sum(head.stages.values()), 4)
    detail = {
        "n_utts": sz.n_utts,
        "utt_seconds": sz.utt_seconds,
        "batch": sz.batch,
        "sweep": [f"fft@{c}" for c in sz.cutoffs],
        "elapsed_s_best": round(head.best_s, 4),
        "pass_times_s": head.runs,
        "stage_seconds_best_pass": head.stages,
        "stage_sum_vs_elapsed_s": [stage_sum, round(head.best_s, 4)],
        "headline_stft_launches": head.launches,
        "headline_batches_per_pass": -(-sz.n_utts // sz.batch),
        "baseline_utt_per_s": round(base_utt_per_s, 4),
        "baseline_n_utts": sz.n_base,
        "baseline_host": {"cpu": cpu, "cpu_count": os.cpu_count(), "measured_best_of": 2,
                          "note": "float64 NumPy/SciPy reference pipeline, measured in this run"},
        "chip": peaks,
        "headline_utilization": headline_util,
        "headline_drain_split": drain,
        "max_abs_delta_wellconditioned": max_delta_wc,
        "per_key_delta_wellconditioned": per_key_delta_wc,
        "max_abs_delta_device_vs_host_float64": dev_vs_h64,
        "per_key_dLSD_identity_floor_dominated": per_key_dlsd_id,
        "nvsr": nvsr_detail,
        "iir_subsampling_matrix": iir_detail,
        "mp3": mp3_detail,
        "kernel_ab": ab,
        "n_chips": 1,
        "cuda_device_count": torch.cuda.device_count(),
        "backend": device.type,
        "card": card,
        "torch": torch.__version__,
        # over everything this engine ran (warm-up, timed passes, the cost
        # and drain-split calls, the oracle-delta run)
        "engine_stats_cumulative_all_passes": eng.stats.summary(),
    }
    nv_util = nvsr_detail.get("utilization_bf16") or {}
    line_detail = {
        "n_utts": sz.n_utts,
        "sweep_cutoffs_khz": [c / 1000 for c in sz.cutoffs],
        "elapsed_s_best": round(head.best_s, 4),
        "baseline_utt_per_s": round(base_utt_per_s, 4),
        "baseline_host_cpu": cpu[:80],
        "headline_utilization": headline_util,
        "headline_marginal_ms_per_batch": drain["pipelined_marginal_ms_per_call"],
        "headline_stft_launches": head.launches,
        "nvsr_marginal_ms_per_batch_bf16": (nv_util.get("drain_split") or {}).get("pipelined_marginal_ms_per_call"),
        "max_abs_delta_wellconditioned": max_delta_wc,
        "nvsr_utt_per_s_per_chip_bf16": nvsr_detail.get("utt_per_s_per_chip_bf16"),
        "nvsr_utt_per_s_per_chip_f32": nvsr_detail.get("utt_per_s_per_chip_f32"),
        "nvsr_mfu_bf16": nv_util.get("mfu_vs_bf16_peak"),
        "n_chips": 1,
        "backend": device.type,
        "device_kind": peaks.get("device_kind"),
        "card": card,
    }
    line = {
        "metric": "utterances/sec/chip (VCTK fft-sweep eval)",
        "value": round(thr, 3),
        "unit": "utt/s/chip",
        "vs_baseline": round(vs_baseline, 2),
        "detail": line_detail,
    }
    return detail, line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m ssr_eval_tpu_torch.bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--detail", default="bench_torch_detail.json",
                    help="where the full detail JSON goes (default: bench_torch_detail.json in the working directory)")
    args = ap.parse_args(argv)
    sz = QUICK if _flag("SSR_BENCH_QUICK", "0") else FULL
    cpu = _flag("SSR_BENCH_CPU", "0")
    if not cpu and not torch.cuda.is_available():
        _log("needs a CUDA card: torch.cuda.is_available() is False (SSR_BENCH_CPU=1 runs on the CPU)")
        return 2
    device = resolve_device("cpu" if cpu else None)
    with tempfile.TemporaryDirectory(prefix="ssr_bench_") as tmp:
        detail, line = run(sz, device, tmp, nvsr=_flag("SSR_BENCH_NVSR", "1"))
    with open(args.detail, "w") as f:
        json.dump(detail, f, indent=1)
    _log(f"full detail -> {os.path.abspath(args.detail)}")
    line["detail_file"] = args.detail
    print(json.dumps(line, separators=(",", ":")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
