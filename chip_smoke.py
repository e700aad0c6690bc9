#!/usr/bin/env python3
"""Drive ssr_eval_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure raises and the script exits non-zero):
  build      nvcc builds the kernel source csrc/stft_magnitude.cu into the
             checkout's ssr_eval_tpu_torch/_build/ while g++ builds the
             native IO library (csrc/ssrio.cpp) beside it.
  kernel     the |STFT| kernel on the card at the main path's shapes
             (2048/441, 2229/480 and 743/160, 16 buffers -> [16, 744,
             n_bins]; 2048/512 -> [16, 641, 1025], NVSR's post-processing
             cutoff detection) and at the A/B shape [8, 266240] 2048/441
             -> [8, 604, 1025]: max|kernel - plain| <= 1e-4 of max|plain| and
             max|kernel - float64 rfft| <= 2e-6 of its max (the plain
             version's float64 error printed beside it); kernel, plain and
             torch.stft (a yardstick the port never calls) timed with CUDA
             events; the bound computed from the shapes.
  sweep      the headline fft sweep through SSR_Eval_Helper.evaluate on the
             card: 16 speech-like 6 s utterances at 44.1 kHz, 7 cutoffs of
             1-16 kHz, batch 16, a broadband-noise testee.  The kernel's
             launch count must grow by 8 per batch (1 target + 7 estimates).
             Per-pair metrics must agree with the same sweep on the CPU, and
             with the card's sweep under metrics_backend="host_float64",
             within CARD_VS_CPU and, for two utterances, with the float64
             NumPy oracle.
  flac       the sweep's 16 utterances re-encoded as 16-bit FLAC with the
             native encoder (a VCTK-style p000/ layout; each decodes to the
             WAV's int16 samples) and the headline sweep run on them: the
             engine must decode through the native batch decoder
             ("native_batch"), launch the kernel 8 times per batch, and give
             every per-pair metric within 1e-6 of the WAV sweep's; s/batch,
             utt/s and the decode stage beside the WAV sweep's; the native
             decode_batch against the pure-Python flac_py on those files and
             on the synthetic VCTK set.
  install    the port as a user installs it: pip builds its wheel from a
             copy of ssr_eval_tpu_torch/ (tests/port_install.py) and
             installs it into a read-only directory; a child process (this
             script with -P, the install alone on PYTHONPATH, a fresh HOME,
             a cwd outside the checkout) builds both libraries from the
             installed sources into the fresh user cache (nvcc and g++
             seconds) and runs the flac phase's sweep on the card.  Both
             libraries must load from that cache, the decoders be
             "native_batch", the kernel launch 8 times per batch, no JAX be
             imported, nothing be written into the install, and every pair
             lie within INSTALL_TOL of the flac phase's.
  smoke      ssr_eval_tpu_torch.test() (the README smoke run: 48 kHz
             evaluation, so the 2229-point kernel) on the synthetic VCTK set,
             held to the golden values of the JAX package.
  invariance one file alone vs inside a 3-file batch on the card: 1e-5.
  matrix     the sweep's data through the whole degradation matrix on the
             card: the four IIR designs at 2, 4 and 8 kHz and orders 4 and 8
             (24 specs), subsampling at 2, 4 and 8 kHz and mp3 at 32 and 64
             kbps (the real codec where libmp3lame, sox or ffmpeg is present,
             else a deterministic quantize-and-delay stand-in; the line says
             which).  Warm-up and 3 timed runs with the engine's stage
             seconds, one profiled run, and the |STFT| launch count: 1 target
             + 1 per device spec + 2 per mp3 spec per batch.  Per-pair
             metrics of the first 4 utterances agree with the CPU within the
             sweep's limits; for 2 utterances one spec of each IIR design and
             one subsampling spec agree with a float64 oracle (scipy
             sosfiltfilt / resample_poly + metrics/host_reference.py): LSD <= 1e-3.
  families   the JAX package's multi-family golden run (identity host testee,
             synthetic VCTK, 2 files per speaker) on the card: SiSpec and SSIM
             inside the golden TOL, LSD and log-SiSpec (float32 stop-band
             floors) within FLOOR_TOL of the JAX package's CPU pins.
  utilities  on the FLAC data: run_leaderboard with the noise testee and
             BasicTestee at 4 and 8 kHz on the card and on the CPU (rows
             finite; the noise row within the sweep's LSD bound, the
             identity row within FLOOR_TOL; the markdown printed; |STFT|
             launches 3 + 4 per batch); engine_program_costs of the sweep's
             batch program on the card and on the CPU (FLOP and bytes within
             COST_TOL) with utilization at the sweep's s/batch beside
             chip_peaks(); verify_real.main offline (rc 0, both stages SKIP,
             no fetch attempted); verify_real.run_golden on the synthetic
             VCTK set (ok false, every row finite); examples.test on the
             synthetic set (every family's key finite).
  nvsr       the full-width NVSRTestee("unet") (65M-parameter UNet + the
             512-channel TFGAN vocoder, seeded random weights) through
             SSR_Eval_Helper.evaluate on the sweep's data at the reference's
             NVSR cutoffs (1-12 kHz), batch 16: warm-up and 2 timed runs,
             peak memory, the model's FLOP per batch (utils.flops.count_cost)
             and a profiled run; the |STFT| launch count is exact (1 target + 2
             per spec per batch: NVSR.pre and the metric; 1 + 3 per spec for
             NVSRPostProcTestee, run on 4 utterances).  Card vs CPU with the
             same weights on 2 short utterances (per-pair metrics, log-SiSpec
             through its |cos t|, and waveforms within NVSR_CARD_VS_CPU);
             examples/trained_small on
             the card (vocoder check passes, NVSRPostProcTestee beats the
             identity testee's LSD at every cutoff); bf16 vs fp32 per pair
             within NVSR_BF16 (log-SiSpec through its cosine; LSD also
             within the JAX package's 0.5), both timed.
  train      NVSR training.  (a) the |STFT| backward kernel (one launch,
             every n_fft) at BWD_SHAPES against its plain version (torch
             autograd) and a float64 CPU autograd (BWD_TOL), timed with the
             backward of torch.stft(...).abs() beside it and at the forced
             frames per segment BWD_FORCED; row 0 alone bit-identical to
             row 0 in the batch at 2048/441 and 2229/480, at the kernel's
             choice and at BWD_FORCED; the gradient of the 48 kHz LSD
             (2229/480, Bluestein) with respect to the estimate on the card
             and on the CPU, each against a float64 autograd, whole
             (LSD_GRAD_RATIO) and with the bins float32 cannot resolve held
             constant (LSD_GRAD_TOL).  (b) the full-width
             NVSRTrainer("unet") in examples/train_nvsr.py's configuration:
             fit steps (2 |STFT| launches each, the mel pairs), the
             checkpoint reloaded into NVSRTestee("unet") and run, then 10
             steps on one batch (every loss finite, the last below the
             first), s/step, FLOP/step, peak memory and a profile; the
             remat step: the same step with UNetRes(remat=True) against
             remat=False under cudnn.deterministic (loss, gradients and
             running statistics within REMAT_TOL), peak memory and s/step
             of both.  (c)
             VocoderTrainer(SMALL_TFGAN) in scripts/train_small_nvsr.py's
             configuration: the loss falls, 2 forward and 1 backward
             launch per step, probe_corr, the export reloaded with
             load_vocoder_checkpoint(check=False); the full-width vocoder
             timed.  (d) one backward of the small UNet generator and the
             small vocoder on the card vs the CPU, from the CPU loss's
             cotangent on the CPU's activation branches (TRAIN_CARD_VS_CPU).
  train_small
             ssr_eval_tpu_torch/examples/train_small_nvsr.py's recipe (that of
             scripts/train_small_nvsr.py) on the card into a temporary
             directory: SMALL_TFGAN trained in chunks of 500 steps up to
             TRAIN_SMALL_STEPS[0] (the checked-in train_report.json's 3000),
             stopping at probe correlation 0.65, then the dnn generator for
             TRAIN_SMALL_STEPS[1] steps (300), both written and reassembled
             through NVSRTestee's loaders with the vocoder check on (corr >
             0.5, no unmatched tensors).  Both losses fall (mean of the first
             5 steps above the last 5's); the |STFT| launch counts are exact
             (forward: 2 per vocoder step, 2 per probe, 2 per generator step,
             4 for the two sanity reports; backward: 1 per vocoder step); the
             card-trained NVSRPostProcTestee beats the identity testee's LSD
             at every TRAINED_CUTOFFS cutoff through SSR_Eval_Helper, printed
             beside the JAX-trained examples/trained_small's; the card-trained
             NVSRTestee's waveforms on the card and on the CPU within
             NVSR_CARD_VS_CPU["wave"].
  parallel   init_distributed over NCCL at world size 1 (tcp on a free
             localhost port): SSR_Eval_Helper(mesh=data_mesh())
             .evaluate(multihost=True) on the FLAC data (within 1e-6 of the
             flac phase per pair, one results JSON, the rank's journal), and
             the full-width NVSRTrainer("unet", mesh=make_mesh(tp=1)) one step
             from the plain trainer's init and batch (loss and gradients
             within DP_TOL of each leaf's max), then timed beside the train
             phase's s/step; the process group is destroyed in a finally.

Output: per-phase lines, then the card's name and power limit, a
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
FP32_FLOP_PER_S = 67e12  # H100 SXM, outside the tensor cores

SR = 44100
UTT_SECONDS = 6.0
N_UTTS = 16
BATCH = 16
CUTOFFS = [1000, 2000, 4000, 6000, 8000, 12000, 16000]
NOISE_SEED = 777
# Card vs the CPU run of the same sweep, and the card's metrics vs
# metrics_backend="host_float64", per (file, spec) pair: about 5x the first
# measured maxima on an H100 (LSD 5.0e-5, log-SiSpec 4.4e-4, SiSpec 7.6e-6
# dB, SSIM 1.2e-7; PERF.md).
CARD_VS_CPU = {"lsd": 2.5e-4, "log_sispec": 2e-3, "sispec": 5e-5, "ssim": 1e-6}
# The README smoke run's golden values and tolerances
# (tests/test_golden_synthetic.py).
GOLDEN_AVERAGED = {"lsd": 4.100137, "log_sispec": 5.882068, "sispec": 42.047697, "ssim": 0.654000}
GOLDEN_TOL = {"lsd": 5e-3, "log_sispec": 5e-3, "sispec": 0.05, "ssim": 2e-3}
METRICS = ("lsd", "log_sispec", "sispec", "ssim")
# The degradation matrix (cutoffs before the helper doubles them).
MATRIX = dict(
    setting_lowpass_filtering={"filter": ["butter", "cheby", "ellip", "bessel"],
                               "cutoff_freq": [2000, 4000, 8000], "filter_order": [4, 8]},
    setting_subsampling={"cutoff_freq": [2000, 4000, 8000]},
    setting_mp3_compression={"low_kbps": [32, 64]},
)
MATRIX_CPU_UTTS = 4
# Specs held to the float64 oracle: (key, ftype or None, order, highcut).
MATRIX_ORACLE = [
    ("proc_bw_8000_8_44100", "butter", 8, 4000),
    ("proc_ch_8000_8_44100", "cheby1", 8, 4000),
    ("proc_el_8000_8_44100", "ellip", 8, 4000),
    ("proc_bessel_8000_8_44100", "bessel", 8, 4000),
    ("proc_subsampling_8000_44100", None, 0, 4000),
]
# The JAX package's multi-family golden pins (tests/test_golden_synthetic.py)
# and the float32 stop-band floor tolerance of LSD and log-SiSpec for the
# IIR keys (tests/test_torch_degrade.py::FLOOR_TOL, where the measurements
# behind it are).
GOLDEN_FAMILIES = {
    "proc_bw_16000_8_44100": {"lsd": 6.239049, "log_sispec": 6.125923, "sispec": 42.656927, "ssim": 0.619003},
    "proc_ch_16000_8_44100": {"lsd": 6.542235, "log_sispec": 6.266384, "sispec": 40.906565, "ssim": 0.620322},
    "proc_el_16000_8_44100": {"lsd": 6.810665, "log_sispec": 6.611895, "sispec": 41.202256, "ssim": 0.614572},
    "proc_bessel_16000_8_44100": {"lsd": 6.390809, "log_sispec": 7.295904, "sispec": 26.253575, "ssim": 0.531492},
    "proc_subsampling_16000_44100": {"lsd": 3.389415, "log_sispec": 8.356409, "sispec": 42.388617, "ssim": 0.624253},
}
FLOOR_TOL = {"lsd": 0.6, "log_sispec": 0.5}
# The NVSR phase: the full-width NVSRTestee("unet") on the sweep's data at
# the reference's NVSR cutoffs (examples/nvsr_main.py:31), seeded random
# weights (the pretrained checkpoint is not in the repository).
NVSR_CUTOFFS = [1000, 2000, 4000, 6000, 8000, 12000]
NVSR_SEED = 234
UNET_PARAMS = (5.5e7, 7.5e7)  # the full-width UNet's parameter count
NVSR_BATCH = 16
NVSR_POSTPROC_UTTS = 4
NVSR_SHORT_SECONDS = 1.5  # the card-vs-CPU and trained_small utterances
# Card vs the CPU with the same seeded full-width weights, per (file, spec)
# pair and for the output waveforms (max |card - CPU| / max |CPU|): about
# 5x the larger of the first two measured maxima on an H100 (LSD 2.6e-6,
# SiSpec 5.7e-6 dB, SSIM 9.0e-8, waveform 3.1e-6; PERF.md).  log-SiSpec is
# held through its |cos t| (sispec_cos), as NVSR_BF16 holds it: the CPU's
# log-SiSpec reaches -61 dB on these weights, where the dB form read
# 1.7e-4-1.3e-2 over 7 seeds and moved 1.6e-3-5.2e-3 between card runs of
# one seed (cuDNN's card runs differ from run to run), while |d cos t|
# read 1.3e-6-1.2e-5; TF32 on the card reads 9.8e-5-2.6e-4
# (chip_probes/nvsr_card_vs_cpu.py, PERF.md).  2.6x the largest.
NVSR_CARD_VS_CPU = {"lsd": 1.5e-5, "log_sispec_cos": 3e-5, "sispec": 3e-5, "ssim": 5e-7, "wave": 1.5e-5}
NVSR_BF16_LSD = 0.5  # per pair, tests/test_models.py::test_bf16_inference_mode
# bf16 vs fp32 per pair: the JAX package's 0.5 alone would pass a bf16
# path that was badly wrong.  LSD, SiSpec (dB) and SSIM: about 5x the first
# measured maxima on an H100 (3.96e-4, 0.0191, 3.6e-5; PERF.md).
# log-SiSpec is held through the cosine it encodes, |cos t| (sispec_cos):
# on random weights the estimate's log spectrogram sits nearly orthogonal
# to the target's (log-SiSpec down to -87 dB), where a bf16 rounding that
# moves cos t by 1e-4 moves the dB by tens, while |d cos t| is bounded by
# the estimate's relative change.  2x the largest of 14 draws (5.1e-3;
# chip_probes/init_checks.py); weights rounded to 4 mantissa bits read
# 1.3e-2.
NVSR_BF16 = {"lsd": 2e-3, "log_sispec_cos": 1e-2, "sispec": 0.1, "ssim": 2e-4}
TRAINED_CUTOFFS = [2000, 4000, 6000]  # doubled by the helper: tests/test_trained_small.py:38
# The train_small phase: (vocoder step cap, generator steps) of the recipe,
# scripts/train_small_nvsr.py's counts for the checked-in artifacts.
TRAIN_SMALL_STEPS = (3000, 300)
# The train phase.  The |STFT| backward kernel's shapes: the vocoder loss's
# [4, 36 frames] (0.35 s crops: 35 conditioning frames -> 15,435 synthesized
# samples -> 36), [16, 604 frames] and 512/128, and the kernel phase's 48 kHz
# (2229/480) and 16 kHz (743/160) metric STFTs at [16, 744] (Bluestein).
# Gate: 1e-5 of max|grad| of a float64 CPU autograd (float32 FFTs round at
# ~1e-6 of max) and 1e-4 of max of the plain version on the card.
BWD_SHAPES = [(4, 36, 2048, 441), (16, 604, 2048, 441), (16, 257, 512, 128), (16, 744, 2229, 480),
              (16, 744, 743, 160)]
BWD_TOL = 1e-5
BWD_PLAIN_TOL = 1e-4
# Frames per segment forced besides the kernel's own choice: the batch
# invariance check (row 0 alone vs in the batch, bit for bit) runs at each,
# and the kernel is timed at each beside its choice.
BWD_FORCED = (1, 3, 16)
# The 48 kHz metric gradient: d LSD / d estimate for 2 utterances of this
# length.  LSD's gradient is ill-conditioned: d LSD / d|X| grows as 1/|X| at
# the estimate's smallest bins, where float32 resolves the phase X/|X|
# worst, so on speech plus a 1e-3 floor the CPU's own float32 gradient
# sits ~1e-2 of max off float64.  The whole gradient is held no further
# from a float64 CPU autograd than LSD_GRAD_RATIO x the CPU's float32
# autograd (tests/test_torch_train_vocoder.py's rule for ill-conditioned
# gradients).  With the estimate's bins below LSD_GRAD_FLOOR x their
# frame's rms held constant (about a third of the bins; the CPU's float32 error
# falls to ~3e-5 of max), the card is held within LSD_GRAD_TOL of the
# float64 autograd and of the CPU.
LSD_GRAD_SECONDS, LSD_GRAD_RATIO, LSD_GRAD_FLOOR, LSD_GRAD_TOL = 1.5, 1.5, 1e-2, 1e-4
# The generator in examples/train_nvsr.py's configuration: 16 speech-like
# 2 s clips, batch 8, 1 s crops, lr 1e-4, cutoffs 2-12 kHz; a few fit steps,
# then steps on one fixed batch.
GEN_AUDIOS, GEN_BATCH, GEN_CROP, GEN_LR = 16, 8, 1.0, 1e-4
GEN_CUTOFFS = (2000, 4000, 8000, 12000)
GEN_FIT_STEPS, GEN_FIXED_STEPS = 3, 10
# The vocoder in scripts/train_small_nvsr.py's configuration (SMALL_TFGAN,
# batch 4, 0.35 s crops, lr 2e-4) for a fixed step count, and the
# full-width TFGANConfig() timed for a few steps.
VOC_BATCH, VOC_CROP, VOC_LR, VOC_STEPS = 4, 0.35, 2e-4, 60
VOC_FULL_STEPS, VOC_FULL_CHANNELS = 3, 512
# Card vs CPU, one backward of the small UNet generator and of the small
# vocoder, per leaf: max|card - CPU| over max(max|CPU leaf|,
# TRAIN_GRAD_FLOOR x the largest CPU gradient of the model).  The card
# backpropagates the CPU loss's cotangent at the model's output, with
# every relu and leaky ReLU on the CPU's branches (cotangent_grads): an
# element within rounding of a kink (the loss's |.|, an activation's 0)
# takes the other branch on one device at some draws of random weights,
# which moved a leaf by up to 4.4e-2 of its max on either side, the
# float64 CPU run included (chip_probes/init_checks.py, PERF.md).  The
# floor holds the UNet's sums that cancel or are 0 (the shortcut biases a
# BatchNorm removes, ~1e-8 of the largest; the 1-channel input
# BatchNorm's scale, <= 2.2e-5), where both devices return rounding noise,
# up to 1.2e-6 of the largest on the card, and at some draws a few
# BatchNorm leaves at 1.2e-3-3e-3 of it.  fp32 runs without TF32.  Over
# 14 draws the readings reach 3.9e-4 (generator) and 1.0e-5 (vocoder);
# TF32 on the card moves the vocoder 6.4e-4 to 1.4e-2.
TRAIN_GRAD_FLOOR = 3e-3
TRAIN_CARD_VS_CPU = {"generator": 1.5e-3, "vocoder": 2e-5}
# The parallel phase: the data-parallel generator step at world size 1 vs the
# plain step from the same init and batch, loss and every gradient leaf
# within DP_TOL of the leaf's own max (and the loss, relative).  Both
# steps run with cudnn.deterministic: cuDNN's default algorithms make two
# plain steps differ by up to 2.9e-5 of the model's largest gradient on an
# H100, and a last-bit change in one BatchNorm's mean moves the gradients
# as far.  At one rank the synchronised BatchNorm averages its own
# moments over one rank, which leaves them bit for bit (models/unet.py).
DP_TOL = 1e-6
# The remat step: the full-width generator step with UNetRes(remat=True)
# against remat=False, both under cudnn.deterministic (the recomputation
# runs the same kernels on the same inputs): loss, every gradient leaf and
# every running statistic within REMAT_TOL of the leaf's own max; timed
# over REMAT_STEPS steps each.
REMAT_TOL, REMAT_STEPS = 1e-6, 5
# The utilities phase: the leaderboard at 4 and 8 kHz on the FLAC data, the
# noise testee beside the identity BasicTestee.  The noise testee's rows
# are held card vs CPU to the sweep's LSD bound; the identity rows read
# the float32 rounding floor of the masked iSTFT at the deep bands, which
# cuFFT and the CPU's FFT leave at different levels, and are held to
# FLOOR_TOL's LSD (tests/test_torch_utilities.py holds the same rows port
# vs JAX so).  The engine's cost of the sweep's batch program, card vs CPU:
# FLOP and bytes within COST_TOL.
LEADERBOARD_KHZ = [4, 8]
COST_TOL = 0.01

# install: the installed port's FLAC sweep against the flac phase's, per pair
# (PERF.md section 2's FLAC-vs-WAV limit; the same source and flags give 0)
INSTALL_TOL = 1e-6


def log(*a):
    print(*a, flush=True)


def card_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_noise():
    """The well-conditioned testee's broadband floor: 1e-3 N(0, 1), 2^17
    samples, seed NOISE_SEED."""
    return (1e-3 * np.random.default_rng(NOISE_SEED).standard_normal(1 << 17)).astype(np.float32)


def noisy_testee(device):
    """The well-conditioned testee with its noise on `device` -> (testee,
    noise).  It adds a fixed noise (make_noise, its device state) to its
    input, so estimated spectra sit far above any float32 rounding floor
    and deltas against the float64 oracle measure the pipeline (PARITY.md
    deviation 4)."""
    import torch

    from ssr_eval_tpu_torch.harness.testee import BatchedTestee, state_from_numpy

    class NoisyTestee(BatchedTestee):
        def __init__(self, noise):
            self.noise = noise

        def device_state(self):
            return self.noise

        def infer_batch(self, x, lengths, state=None):
            ar = torch.arange(x.shape[1], device=x.device)
            mask = (ar[None, :] < lengths[:, None]).to(torch.float32)
            return x.to(torch.float32) + state[ar % state.shape[0]][None, :] * mask, lengths

    noise = make_noise()
    return NoisyTestee(state_from_numpy(noise, device)), noise


def f64_pipeline_one(path, cutoffs, noise=None):
    """The reference fft sweep for one utterance at SR in float64: {key: the
    four metrics}; `noise` is added to every estimate as the noisy testee
    adds it."""
    from ssr_eval_tpu_torch.io.audio import decode_audio
    from ssr_eval_tpu_torch.metrics.host_reference import istft_np, spectral_metrics_np, stft_np

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


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------


def build_both():
    """nvcc for csrc/stft_magnitude.cu and g++ for csrc/ssrio.cpp at once ->
    (kernel library, nvcc seconds, IO library, g++ seconds)."""
    from concurrent.futures import ThreadPoolExecutor

    from ssr_eval_tpu_torch._native_build import CSRC, build

    def timed(name):
        t = time.perf_counter()
        return build(CSRC / name), time.perf_counter() - t

    with ThreadPoolExecutor(2) as ex:
        native = ex.submit(timed, "ssrio.cpp")
        kernel_lib, cuda_s = timed("stft_magnitude.cu")
        lib, native_s = native.result()
    return kernel_lib, cuda_s, lib, native_s


def _ptxas_lines(lib):
    log_text = lib.with_suffix(".log").read_text()
    return " | ".join(ln.strip() for ln in log_text.splitlines() if "Used" in ln or "spill" in ln)


def phase_build():
    kernel_lib, cuda_s, lib, native_s = build_both()
    log(f"[build] kernel library {kernel_lib.name} built by nvcc in {cuda_s:.2f} s; native IO library "
        f"{lib.name} built by g++ in {native_s:.2f} s")
    log(f"[build] {kernel_lib.name}: {_ptxas_lines(kernel_lib)}")


def stft_bound(B, ext_len, mf, n_fft):
    """Least time for the |STFT| call on this card: bytes (ext read once,
    magnitudes written once) vs an FFT-class operation count
    (2.5 N log2 N per frame for a real transform, 3 per bin for |.|)."""
    from ssr_eval_tpu_torch.utils.flops import stft_magnitude_cost

    flops, nbytes = stft_magnitude_cost(B, ext_len, mf, n_fft)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def phase_kernel():
    import torch

    from ssr_eval_tpu_torch.dsp.spectral import window_tensor
    from ssr_eval_tpu_torch.dsp.stft_kernel import _fft_plan, stft_magnitude_kernel, stft_magnitude_plain

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    shapes = []
    # ext lengths of the main path for a 6 s utterance: the 44.1 kHz bucket
    # (327,680) at 44.1 kHz evaluation (and NVSR.pre), and that bucket
    # resampled to the 48 kHz (356,660) and 16 kHz (118,886) evaluation
    # rates; all give 744 frames.
    # 2048/512 is the NVSR post-processing cutoff detection on the bucket.
    # [8, 266240] is the root bench.py's kernel A/B shape (604 frames).
    for rows, n_fft, hop, body in ((BATCH, 2048, 441, 327680), (BATCH, 2229, 480, 356660),
                                   (BATCH, 743, 160, 118886), (BATCH, 2048, 512, 327680), (8, 2048, 441, 266240)):
        ext_len = body + 2 * (n_fft // 2)
        mf = 1 + (ext_len - n_fft) // hop
        ext = 0.1 * torch.randn(rows, ext_len, generator=g, device=dev)
        win = window_tensor(n_fft, n_fft, dev)
        got = stft_magnitude_kernel(ext, n_fft, hop, mf, win)
        torch.cuda.synchronize()
        want = stft_magnitude_plain(ext, n_fft, hop, mf, win)
        ref = torch.fft.rfft(ext.double().unfold(-1, n_fft, hop)[:, :mf] * win.double(), dim=-1).abs()
        peak = ref.max().item()
        max_abs = (got - want).abs().max().item()
        rel = max_abs / want.abs().max().item()
        rel64 = (got.double() - ref).abs().max().item() / peak
        plain_rel64 = (want.double() - ref).abs().max().item() / peak
        del ref
        if not (got.shape == want.shape == (rows, mf, n_fft // 2 + 1)) or not rel <= 1e-4 or not rel64 <= 2e-6:
            raise AssertionError(
                f"stft kernel {n_fft}/{hop}: shape {tuple(got.shape)}, vs plain {rel:.3e} (limit 1e-4), "
                f"vs float64 {rel64:.3e} (limit 2e-6)"
            )
        ms = cuda_ms(lambda: stft_magnitude_kernel(ext, n_fft, hop, mf, win))
        plain_ms = cuda_ms(lambda: stft_magnitude_plain(ext, n_fft, hop, mf, win))
        library_ms = cuda_ms(
            lambda: torch.stft(ext, n_fft, hop, window=win, center=False, return_complex=True).abs()
        )
        bound_ms, bound_by, nbytes, flops = stft_bound(rows, ext_len, mf, n_fft)
        plan = _fft_plan(n_fft)
        s = dict(
            n_fft=n_fft, hop=hop, shape=[rows, mf, n_fft // 2 + 1], ext_len=ext_len,
            path=plan.kind, fft_len=plan.fft_len,
            max_abs_err=max_abs, max_rel_err=rel, max_rel_err_f64=rel64, plain_max_rel_err_f64=plain_rel64,
            ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
            bytes=nbytes, fft_flops=flops,
        )
        log("[kernel]", json.dumps(s))
        shapes.append(s)
    return shapes


def _write_sweep_data(root):
    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.io.audio import write_wav

    spk = os.path.join(root, "p000")
    os.makedirs(spk)
    for i in range(N_UTTS):
        write_wav(os.path.join(spk, f"utt_{i:03d}.wav"), speechlike(UTT_SECONDS, SR, seed=1000 + i), SR)
    return spk


def _pairs(res):
    return {
        (spk, f, key): m
        for spk, files in res.items()
        if spk not in ("each_speaker", "averaged")
        for f, specs in files.items()
        for key, m in specs.items()
    }


def phase_sweep(work):
    import torch

    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel

    root = os.path.join(work, "sweep_data")
    spk = _write_sweep_data(root)
    kw = dict(
        input_sr=SR, output_sr=SR, evaluation_sr=SR, test_name="chip_sweep",
        test_data_root=root, setting_fft={"cutoff_freq": CUTOFFS},
        auto_download=False, batch_size=BATCH,
    )
    testee, noise = noisy_testee(torch.device("cuda"))
    helper = ssr_eval_tpu_torch.SSR_Eval_Helper(testee, **kw)
    n_batches = -(-N_UTTS // BATCH)

    t = time.perf_counter()
    helper.evaluate(verbose=False)  # warm: allocator, cuFFT plans, constants
    warm_s = time.perf_counter() - t

    stft_magnitude_kernel.launches = 0
    card = helper.evaluate(verbose=False)
    launches = stft_magnitude_kernel.launches
    want = n_batches * (1 + len(CUTOFFS))
    if launches != want:
        raise AssertionError(f"|STFT| kernel launched {launches} times in the sweep, expected {want}")

    times, decode_s = timed_runs(helper)
    best = min(times)
    log(
        f"[sweep] warm-up {warm_s:.3f} s; timed runs {[round(x, 4) for x in times]} s; "
        f"best {best / n_batches:.4f} s/batch, {N_UTTS / best:.2f} utt/s "
        f"({N_UTTS} utts x {len(CUTOFFS)} cutoffs, batch {BATCH}); kernel launches {launches}; "
        f"decode stage {decode_s:.4f} s per timed run"
    )
    log("[sweep] stages over all card runs:", json.dumps(helper.engine.stats.summary()))
    profile_sweep(helper)

    cpu_testee, _ = noisy_testee(torch.device("cpu"))
    t = time.perf_counter()
    cpu_helper = ssr_eval_tpu_torch.SSR_Eval_Helper(cpu_testee, device="cpu", **kw)
    cpu = cpu_helper.evaluate(verbose=False)
    cpu_s = time.perf_counter() - t
    pc, pg = _pairs(cpu), _pairs(card)
    if set(pc) != set(pg) or len(pg) != N_UTTS * len(CUTOFFS):
        raise AssertionError("card and CPU sweeps scored different (file, spec) pairs")
    delta = {k: max(abs(pg[p][k] - pc[p][k]) for p in pg) for k in METRICS}
    finite = all(math.isfinite(pg[p][k]) for p in pg for k in METRICS)
    log(f"[sweep] CPU run {cpu_s:.2f} s; max |card - CPU| per pair: {json.dumps(delta)}")
    if not finite or any(delta[k] > CARD_VS_CPU[k] for k in METRICS):
        raise AssertionError(f"card vs CPU parity failed: {delta} (limits {CARD_VS_CPU}, finite={finite})")

    h64 = ssr_eval_tpu_torch.SSR_Eval_Helper(testee, metrics_backend="host_float64", **kw).evaluate(verbose=False)
    delta, finite = _stem_delta(h64, card)
    log(f"[sweep] max |device metrics - metrics_backend=\"host_float64\"| per pair on the card: {json.dumps(delta)}")
    if not finite or any(delta[k] > CARD_VS_CPU[k] for k in METRICS):
        raise AssertionError(f"device vs host_float64 metrics failed: {delta} (limits {CARD_VS_CPU}, finite={finite})")

    oracle = {k: 0.0 for k in METRICS}
    for i in range(2):
        f = f"utt_{i:03d}.wav"
        ref = f64_pipeline_one(os.path.join(spk, f), CUTOFFS, noise)
        for key, m in ref.items():
            for k in METRICS:
                oracle[k] = max(oracle[k], abs(card["p000"][f][key][k] - m[k]))
    log(f"[sweep] max |card - float64 oracle| over 2 utterances x 7 cutoffs: {json.dumps(oracle)}")
    if oracle["lsd"] > 1e-3:
        raise AssertionError(f"card LSD off the float64 oracle by {oracle['lsd']:.3e} (limit 1e-3)")
    log("[sweep] averaged:", json.dumps(card["averaged"]))
    return {"launches": launches, "root": root, "kw": kw, "card": card, "s_per_batch": best / n_batches,
            "utt_per_s": N_UTTS / best, "decode_s": decode_s, "engines": (helper.engine, cpu_helper.engine)}


def timed_runs(helper, n=3):
    """n warm sweeps -> (their seconds, the engine's decode stage seconds
    per run)."""
    times = []
    d0 = helper.engine.stats.seconds["decode"]
    for _ in range(n):
        t = time.perf_counter()
        helper.evaluate(verbose=False)
        times.append(time.perf_counter() - t)
    return times, (helper.engine.stats.seconds["decode"] - d0) / n


def _by_stem(res):
    """(speaker, file stem, key) -> metrics: a WAV and a FLAC sweep of the
    same PCM compare pair by pair."""
    return {(spk, os.path.splitext(f)[0], key): m for (spk, f, key), m in _pairs(res).items()}


def _stem_delta(a, b):
    pa, pb = _by_stem(a), _by_stem(b)
    if not pa or set(pa) != set(pb):
        raise AssertionError("two sweeps scored different (file, spec) pairs")
    finite = all(math.isfinite(pa[p][k]) for p in pa for k in METRICS)
    return {k: max(abs(pa[p][k] - pb[p][k]) for p in pa) for k in METRICS}, finite


def _decoder_seconds(paths):
    """(native decode_batch, the port's pure-Python flac_py) seconds over
    `paths`, each after one warm read of the files."""
    from ssr_eval_tpu_torch.io import flac_native, flac_py

    flac_native.decode_batch(paths, 8)
    t = time.perf_counter()
    flac_native.decode_batch(paths, 8)
    native_s = time.perf_counter() - t
    t = time.perf_counter()
    for p in paths:
        flac_py.decode_flac(p)
    return native_s, time.perf_counter() - t


def phase_flac(work, sweep):
    """The headline sweep again on the same PCM written as 16-bit FLAC in a
    VCTK-style layout, decoded by the native batch decoder."""
    import torch

    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel
    from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk
    from ssr_eval_tpu_torch.io import flac_native
    from ssr_eval_tpu_torch.io.audio import flac_codec, read_wav_i16

    t = time.perf_counter()
    codec = flac_codec()  # builds csrc/ssrio.cpp unless the build phase did
    log(f"[flac] codec {codec} ({time.perf_counter() - t:.2f} s to load)")
    if codec != "native":
        raise AssertionError("the native FLAC library did not build")
    root = os.path.join(work, "flac_data")
    spk = os.path.join(root, "p000")
    os.makedirs(spk)
    wav_dir = os.path.join(sweep["root"], "p000")
    flac_paths = []
    for f in sorted(os.listdir(wav_dir)):
        pcm, sr = read_wav_i16(os.path.join(wav_dir, f))
        p = os.path.join(spk, os.path.splitext(f)[0] + ".flac")
        flac_native.encode(p, pcm.astype(np.float32) / np.float32(32768.0), sr)
        got, got_sr = flac_native.decode_i16(p)
        if got_sr != sr or not np.array_equal(got, pcm):
            raise AssertionError(f"{p}: the FLAC does not decode to the WAV's int16 samples")
        flac_paths.append(p)
    kw = dict(sweep["kw"], test_data_root=root, test_name="chip_flac")
    testee, _ = noisy_testee(torch.device("cuda"))
    helper = ssr_eval_tpu_torch.SSR_Eval_Helper(testee, **kw)
    n_batches = -(-N_UTTS // BATCH)
    helper.evaluate(verbose=False)  # warm-up
    stft_magnitude_kernel.launches = 0
    card = helper.evaluate(verbose=False)
    launches = stft_magnitude_kernel.launches
    times, decode_s = timed_runs(helper)
    best = min(times)
    delta, finite = _stem_delta(card, sweep["card"])
    decoders = helper.engine.stats.decoders
    log(f"[flac] {len(flac_paths)} x {UTT_SECONDS} s 16-bit FLAC, decoders {sorted(decoders)}; timed runs "
        f"{[round(x, 4) for x in times]} s; best {best / n_batches:.4f} s/batch, {N_UTTS / best:.2f} utt/s, "
        f"decode stage {decode_s:.4f} s per timed run (WAV sweep: {sweep['s_per_batch']:.4f} s/batch, "
        f"{sweep['utt_per_s']:.2f} utt/s, decode {sweep['decode_s']:.4f} s); kernel launches {launches}")
    log(f"[flac] max |FLAC sweep - WAV sweep| per pair: {json.dumps(delta)}")
    log("[flac] stages over all card runs:", json.dumps(helper.engine.stats.summary()))
    if decoders != {"native_batch"}:
        raise AssertionError(f"the FLAC sweep decoded through {sorted(decoders)}, not the native batch decoder")
    if launches != n_batches * (1 + len(CUTOFFS)):
        raise AssertionError(f"|STFT| kernel launched {launches} times in the FLAC sweep")
    if not finite or any(delta[k] > 1e-6 for k in METRICS):
        raise AssertionError(f"FLAC sweep off the WAV sweep: {delta} (limit 1e-6)")
    vctk = ensure_synthetic_vctk(os.path.join(work, "vctk_test"), files_per_speaker=2)
    vctk_paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(vctk) for f in fs if f.endswith(".flac"))
    for name, paths in (("the sweep's 16 x 6 s at 44.1 kHz", flac_paths),
                        (f"the synthetic VCTK set ({len(vctk_paths)} files at 48 kHz)", vctk_paths)):
        native_s, py_s = _decoder_seconds(paths)
        log(f"[flac] decode {name}: native decode_batch {native_s:.4f} s, pure-Python flac_py {py_s:.4f} s "
            f"({py_s / native_s:.1f}x) on this host's CPU")
    return {"launches": launches, "root": root, "kw": kw, "card": card, "s_per_batch": best / n_batches}


def install_child(kw_json, out):
    """The FLAC headline sweep from an installed port: phase_install runs
    this script with `-P`, the install alone on PYTHONPATH, a fresh HOME and
    a cwd outside the checkout.  Builds both libraries (timed), runs the
    sweep (warm-up, one counted run, 3 timed runs) and writes what it saw to
    `out` as JSON."""
    import importlib.util

    import torch

    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch.dsp import stft_kernel
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel
    from ssr_eval_tpu_torch.io.audio import flac_codec

    kernel_lib, cuda_s, io_lib, native_s = build_both()
    codec = flac_codec()
    testee, _ = noisy_testee(torch.device("cuda"))
    helper = ssr_eval_tpu_torch.SSR_Eval_Helper(testee, **json.loads(kw_json))
    helper.evaluate(verbose=False)  # warm-up
    stft_magnitude_kernel.launches = 0
    card = helper.evaluate(verbose=False)
    launches = stft_magnitude_kernel.launches
    times, decode_s = timed_runs(helper)
    with open(out, "w") as f:
        json.dump({
            "file": ssr_eval_tpu_torch.__file__, "nvcc_s": cuda_s, "gxx_s": native_s,
            "kernel_lib": str(kernel_lib), "kernel_loaded": stft_kernel._library()._name,
            "ptxas": _ptxas_lines(kernel_lib), "io_lib": str(io_lib), "codec": codec,
            "decoders": sorted(helper.engine.stats.decoders), "launches": launches, "times": times,
            "decode_s": decode_s, "card": card,
            "jax_modules": sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "ssr_eval_tpu")),
            "sees_the_checkout": importlib.util.find_spec("ssr_eval_tpu") is not None
            or any(p and os.path.realpath(p) == ROOT for p in sys.path),
        }, f)
    return 0


def phase_install(work, flac):
    """The port as a user installs it: its wheel built by pip from a copy of
    ssr_eval_tpu_torch/, installed into work/install/site and made read-only;
    then install_child runs the FLAC headline sweep from that install."""
    import ssr_eval_tpu_torch
    from tests.port_install import build_wheel, copy_package, install_read_only, make_writable

    base = os.path.join(work, "install")
    t = time.perf_counter()
    wheel = build_wheel(copy_package(base), os.path.join(base, "dist"))
    site = install_read_only(wheel, os.path.join(base, "site"))
    pip_s = time.perf_counter() - t
    home, cwd, out = (os.path.join(base, n) for n in ("home", "cwd", "result.json"))
    os.makedirs(home)
    os.makedirs(cwd)
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "XDG_CACHE_HOME")}
    env.update(PYTHONPATH=str(site), HOME=home)
    before = sorted(str(p) for p in site.rglob("*"))
    try:
        r = subprocess.run(
            [sys.executable, "-P", os.path.abspath(__file__), "--install-child",
             json.dumps(dict(flac["kw"], test_name="chip_install")), out],
            cwd=cwd, env=env, capture_output=True, text=True, timeout=900,
        )
        after = sorted(str(p) for p in site.rglob("*"))
    finally:
        make_writable(site)
    if r.returncode != 0:
        raise AssertionError(f"the installed port's sweep failed (rc {r.returncode}):\n"
                             f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
    with open(out) as f:
        res = json.load(f)
    cache = os.path.join(home, ".cache", "ssr_eval_tpu_torch", ssr_eval_tpu_torch.__version__)
    n_batches = -(-N_UTTS // BATCH)
    best = min(res["times"])
    delta, finite = _stem_delta(res["card"], flac["card"])
    log(f"[install] {wheel.name} built and installed read-only by pip in {pip_s:.2f} s; imported from "
        f"{res['file']}")
    log(f"[install] from the installed sources into a fresh cache: nvcc {res['nvcc_s']:.2f} s, "
        f"g++ {res['gxx_s']:.2f} s; kernel library {res['kernel_loaded']}; IO library {res['io_lib']}")
    log(f"[install] {os.path.basename(res['kernel_lib'])}: {res['ptxas']}")
    log(f"[install] FLAC sweep from the install: decoders {res['decoders']}; timed runs "
        f"{[round(x, 4) for x in res['times']]} s; best {best / n_batches:.4f} s/batch, {N_UTTS / best:.2f} utt/s, "
        f"decode stage {res['decode_s']:.4f} s per timed run (flac phase: {flac['s_per_batch']:.4f} s/batch); "
        f"kernel launches {res['launches']}")
    log(f"[install] max |installed sweep - flac phase| per pair: {json.dumps(delta)}")
    for key in ("kernel_lib", "kernel_loaded", "io_lib"):
        if os.path.dirname(res[key]) != cache:
            raise AssertionError(f"{key} {res[key]} is not in the fresh cache {cache}")
    if not res["file"].startswith(str(site) + os.sep) or res["sees_the_checkout"]:
        raise AssertionError(f"the child imported {res['file']} or could see the checkout")
    if res["jax_modules"]:
        raise AssertionError(f"the installed port imported {res['jax_modules']}")
    if res["codec"] != "native" or res["decoders"] != ["native_batch"]:
        raise AssertionError(f"the installed port decoded FLAC through {res['codec']} / {res['decoders']}")
    if res["launches"] != n_batches * (1 + len(CUTOFFS)):
        raise AssertionError(f"|STFT| kernel launched {res['launches']} times in the installed sweep")
    if before != after:
        raise AssertionError(f"the run wrote into the install: {sorted(set(after) - set(before))[:5]}")
    if not finite or any(delta[k] > INSTALL_TOL for k in METRICS):
        raise AssertionError(f"installed sweep off the flac phase: {delta} (limit {INSTALL_TOL})")
    return res["launches"]


def profile_sweep(helper, tag="profile"):
    """One more warm sweep under torch.profiler (see profile_call)."""
    return profile_call(lambda: helper.evaluate(verbose=False), tag)


def profile_call(fn, tag, keep="stft_fft_kernel"):
    """fn() under torch.profiler: device busy time (the union of kernel and
    copy intervals), the wall time, the idle share, and the device time by
    kernel name (the top 12, and every kernel whose name holds `keep`).
    Returns the device busy ms, or None when the profiler saw no device
    event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    if not spans:
        log(f"[{tag}] wall {wall_ms:.1f} ms; device time not measured (the profiler saw no CUDA events)")
        return None
    busy, cur_s, cur_e = 0.0, None, None
    for s0, e0, _ in spans:
        if cur_e is None or s0 > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy = (busy + cur_e - cur_s) / 1e3
    by_name = {}
    for s0, e0, name in spans:
        tot, n = by_name.get(name, (0.0, 0))
        by_name[name] = (tot + (e0 - s0) / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    # the top 12 by device time, and the |STFT| kernels wherever they rank
    top = ranked[:12] + [kv for kv in ranked[12:] if keep in kv[0]]
    log(f"[{tag}] wall {wall_ms:.1f} ms (under the profiler), device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}, {len(spans)} device events")
    for name, (ms, n) in top:
        log(f"[{tag}]   {ms:8.3f} ms  x{n:<4d} {name[:110]}")
    return busy


def phase_smoke(work):
    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel
    from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk

    root = ensure_synthetic_vctk(os.path.join(work, "vctk_test"), files_per_speaker=2)
    before = stft_magnitude_kernel.launches
    r = ssr_eval_tpu_torch.test(test_data_root=root, auto_download=False, batch_size=4)
    got = r["averaged"]["proc_fft_24000_44100"]
    log("[smoke] averaged:", json.dumps(r["averaged"]),
        f"kernel launches {stft_magnitude_kernel.launches - before}")
    off = {k: got[k] - v for k, v in GOLDEN_AVERAGED.items() if not abs(got[k] - v) < GOLDEN_TOL[k]}
    if off or stft_magnitude_kernel.launches == before:
        raise AssertionError(f"smoke run off the golden values: {off}")


def phase_invariance(work):
    import torch

    from ssr_eval_tpu_torch.degrade.plan import expand_settings
    from ssr_eval_tpu_torch.harness.engine import EvalEngine
    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.io.audio import write_wav

    paths = []
    for i, dur in enumerate([0.4, 0.7, 0.9]):
        p = os.path.join(work, f"inv{i}.wav")
        write_wav(p, speechlike(dur, SR, seed=40 + i), SR)
        paths.append(p)
    specs = expand_settings(setting_fft={"cutoff_freq": [8000]}, sr=SR)
    testee, _ = noisy_testee(torch.device("cuda"))
    r_all = EvalEngine(specs, SR, SR, SR, testee, batch_size=3).evaluate_files(paths)
    one = EvalEngine(specs, SR, SR, SR, testee, batch_size=1)
    worst = 0.0
    for p in paths:
        r_one = one.evaluate_files([p])
        for k in METRICS:
            worst = max(worst, abs(r_all[p][specs[0].key][k] - r_one[p][specs[0].key][k]))
    log(f"[invariance] max |alone - in batch of 3| = {worst:.3e}")
    if not worst < 1e-5:
        raise AssertionError(f"batch-composition invariance failed: {worst:.3e}")


def _stub_encode_decode(src_wav, kbps, backend, workdir):
    """Deterministic stand-in for a codec round trip (tests/test_degrade.py's
    stub): quantize harder and delay by 37 samples."""
    from ssr_eval_tpu_torch.io.audio import read_wav, write_wav

    y, sr = read_wav(src_wav)
    y = np.concatenate([np.zeros(37, np.float32), np.round(y * 2048) / 2048]).astype(np.float32)
    out = os.path.join(workdir, "dec.wav")
    write_wav(out, y, sr)
    return out


def mp3_codec():
    """-> the codec the mp3 specs run: the real backend where one exists,
    else the stand-in, installed the way tests/test_degrade.py does."""
    from ssr_eval_tpu_torch.degrade import codec

    backend = codec.detect_backend()
    if backend is not None:
        return backend
    codec.detect_backend = lambda: "stub"
    codec._encode_decode_mp3 = _stub_encode_decode
    return "stub (no libmp3lame, sox or ffmpeg on this machine)"


def _oracle_matrix(path, noise):
    """One IIR spec per design and one subsampling spec for one utterance in
    float64 (scipy designs and filters, metrics.host_reference's metrics)."""
    from scipy import signal as sps

    from ssr_eval_tpu_torch.io.audio import decode_audio
    from ssr_eval_tpu_torch.metrics.host_reference import lsd_np, sispec_np, ssim_np, stft_np

    x = decode_audio(path)[0].astype(np.float64)
    tgt_sp = np.abs(stft_np(x, 2048, 441)).T
    design = {
        "butter": lambda o, wn: sps.butter(o, wn, output="sos"),
        "cheby1": lambda o, wn: sps.cheby1(o, 0.1, wn, output="sos"),
        "ellip": lambda o, wn: sps.ellip(o, 0.1, 60, wn, output="sos"),
        "bessel": lambda o, wn: sps.bessel(o, wn, output="sos"),
    }
    out = {}
    for key, ftype, order, highcut in MATRIX_ORACLE:
        if ftype is None:
            fs_down = int(highcut / int(SR / 2) * 44100)  # the fs_ori = 44100 quirk
            y = sps.resample_poly(sps.resample_poly(x, fs_down, 44100), 44100, fs_down)[: len(x)]
            y = np.pad(y, (0, len(x) - len(y)))
        else:
            y = sps.sosfiltfilt(design[ftype](order, highcut / (SR / 2)), x)
        est = y + noise.astype(np.float64)[np.arange(len(y)) % noise.shape[0]]
        est_sp = np.abs(stft_np(est, 2048, 441)).T
        out[key] = {
            "lsd": lsd_np(est_sp, tgt_sp),
            "log_sispec": sispec_np(np.log10(est_sp + 1e-12), np.log10(tgt_sp + 1e-12)),
            "sispec": sispec_np(est_sp, tgt_sp),
            "ssim": ssim_np(est_sp, tgt_sp),
        }
    return out


def phase_matrix(work):
    """The degradation matrix on the sweep phase's data."""
    import torch

    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel
    from ssr_eval_tpu_torch.utils.profiling import StageTimers

    root = os.path.join(work, "sweep_data")
    backend = mp3_codec()
    log(f"[matrix] mp3 codec: {backend}")
    kw = dict(input_sr=SR, output_sr=SR, evaluation_sr=SR, test_name="chip_matrix",
              test_data_root=root, auto_download=False, **MATRIX)
    testee, noise = noisy_testee(torch.device("cuda"))
    helper = ssr_eval_tpu_torch.SSR_Eval_Helper(testee, batch_size=BATCH, **kw)
    n_dev = sum(s.family != "mp3" for s in helper.specs)
    n_mp3 = len(helper.specs) - n_dev
    n_batches = -(-N_UTTS // BATCH)

    t = time.perf_counter()
    helper.evaluate(verbose=False)
    warm_s = time.perf_counter() - t
    helper.engine.stats = StageTimers()
    times = []
    for i in range(3):
        if i == 0:
            stft_magnitude_kernel.launches = 0
        t = time.perf_counter()
        res = helper.evaluate(verbose=False)
        times.append(time.perf_counter() - t)
        if i == 0:
            card, launches = res, stft_magnitude_kernel.launches
    want = n_batches * (1 + n_dev + 2 * n_mp3)
    if launches != want:
        raise AssertionError(f"|STFT| kernel launched {launches} times in the matrix, expected {want}")
    best = min(times)
    log(
        f"[matrix] {len(helper.specs)} specs ({n_dev} device, {n_mp3} mp3) x {N_UTTS} utts, batch {BATCH}: "
        f"warm-up {warm_s:.3f} s; timed runs {[round(x, 4) for x in times]} s; best {best / n_batches:.4f} s/batch, "
        f"{N_UTTS / best:.2f} utt/s; kernel launches {launches} (1 + {n_dev} + 2 x {n_mp3} per batch)"
    )
    log("[matrix] stages over the 3 timed runs:", json.dumps(helper.engine.stats.summary()))
    profile_sweep(helper, tag="matrix-profile")

    cpu_testee, _ = noisy_testee(torch.device("cpu"))
    t = time.perf_counter()
    cpu = ssr_eval_tpu_torch.SSR_Eval_Helper(cpu_testee, device="cpu", batch_size=MATRIX_CPU_UTTS, **kw).evaluate(
        limit_test_nums=MATRIX_CPU_UTTS, verbose=False
    )
    cpu_s = time.perf_counter() - t
    pc, pg = _pairs(cpu), _pairs(card)
    if not set(pc) <= set(pg) or len(pc) != MATRIX_CPU_UTTS * len(helper.specs) or len(pg) != N_UTTS * len(helper.specs):
        raise AssertionError("card and CPU matrix runs scored different (file, spec) pairs")
    delta = {k: max(abs(pg[p][k] - pc[p][k]) for p in pc) for k in METRICS}
    finite = all(math.isfinite(pg[p][k]) for p in pg for k in METRICS)
    log(f"[matrix] CPU run of {MATRIX_CPU_UTTS} utterances {cpu_s:.2f} s; max |card - CPU| per pair: {json.dumps(delta)}")
    if not finite or any(delta[k] > CARD_VS_CPU[k] for k in METRICS):
        raise AssertionError(f"matrix card vs CPU parity failed: {delta} (limits {CARD_VS_CPU}, finite={finite})")

    oracle = {}
    for i in range(2):
        f = f"utt_{i:03d}.wav"
        for key, m in _oracle_matrix(os.path.join(root, "p000", f), noise).items():
            fam = key.split("_")[1]
            for k in METRICS:
                oracle[f"{fam}.{k}"] = max(oracle.get(f"{fam}.{k}", 0.0), abs(card["p000"][f][key][k] - m[k]))
    log(f"[matrix] max |card - float64 oracle| over 2 utterances, per design: {json.dumps(oracle)}")
    worst = max(v for k, v in oracle.items() if k.endswith(".lsd"))
    if worst > 1e-3:
        raise AssertionError(f"matrix card LSD off the float64 oracle by {worst:.3e} (limit 1e-3)")
    log("[matrix] averaged:", json.dumps(card["averaged"]))
    return launches


def _oracle_families(root, paths):
    """The families run in float64 (scipy resample_poly, sosfiltfilt and
    metrics.host_reference's metrics), averaged per speaker and then over
    speakers like the helper."""
    from scipy import signal as sps

    from ssr_eval_tpu_torch.io.audio import decode_audio
    from ssr_eval_tpu_torch.metrics.host_reference import lsd_np, sispec_np, ssim_np, stft_np

    wn = 8000 / 22050
    filters = {
        "proc_bw_16000_8_44100": sps.butter(8, wn, output="sos"),
        "proc_ch_16000_8_44100": sps.cheby1(8, 0.1, wn, output="sos"),
        "proc_el_16000_8_44100": sps.ellip(8, 0.1, 60, wn, output="sos"),
        "proc_bessel_16000_8_44100": sps.bessel(8, wn, output="sos"),
    }
    fs_down = int(8000 / 22050 * 44100)
    per = {}
    for p in paths:
        x, sr = decode_audio(p)
        g = math.gcd(44100, sr)
        x = sps.resample_poly(x.astype(np.float64), 44100 // g, sr // g)
        est = {k: sps.sosfiltfilt(sos, x) for k, sos in filters.items()}
        y = sps.resample_poly(sps.resample_poly(x, fs_down, 44100), 44100, fs_down)[: len(x)]
        est["proc_subsampling_16000_44100"] = np.pad(y, (0, len(x) - len(y)))
        tgt_sp = np.abs(stft_np(x, 2048, 441)).T
        spk = os.path.basename(os.path.dirname(p))
        for key, e in est.items():
            e_sp = np.abs(stft_np(e, 2048, 441)).T
            per.setdefault(key, {}).setdefault(spk, []).append({
                "lsd": lsd_np(e_sp, tgt_sp),
                "log_sispec": sispec_np(np.log10(e_sp + 1e-12), np.log10(tgt_sp + 1e-12)),
                "sispec": sispec_np(e_sp, tgt_sp),
                "ssim": ssim_np(e_sp, tgt_sp),
            })
    return {
        key: {m: float(np.mean([np.mean([r[m] for r in rows]) for rows in spk.values()])) for m in METRICS}
        for key, spk in per.items()
    }


def phase_families(work):
    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel
    from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk

    root = ensure_synthetic_vctk(os.path.join(work, "vctk_test"), files_per_speaker=2)
    helper = ssr_eval_tpu_torch.SSR_Eval_Helper(
        ssr_eval_tpu_torch.BasicTestee(), input_sr=44100, output_sr=44100, evaluation_sr=44100,
        test_name="golden_families", test_data_root=root,
        setting_lowpass_filtering={"filter": ["butter", "cheby", "ellip", "bessel"],
                                   "cutoff_freq": [8000], "filter_order": [8]},
        setting_subsampling={"cutoff_freq": [8000]}, auto_download=False, batch_size=4,
    )
    stft_magnitude_kernel.launches = 0
    r = helper.evaluate(limit_test_nums=2, limit_test_speaker=-1, verbose=False)
    launches = stft_magnitude_kernel.launches
    # host testee: every (batch, spec) scores estimate and target
    want = 2 * len(helper.specs) * helper.engine.stats.counts["decode"]
    paths = sorted(
        os.path.join(root, spk, f) for spk in os.listdir(root) for f in os.listdir(os.path.join(root, spk))
        if "proc" not in f
    )
    truth = _oracle_families(root, paths)
    off = {}
    for key, pins in GOLDEN_FAMILIES.items():
        got = r["averaged"][key]
        d = {m: got[m] - v for m, v in pins.items()}
        log(f"[families] {key}: card - pin {json.dumps(d)}; card {json.dumps(got)}; "
            f"float64 oracle {json.dumps(truth[key])}")
        for m, v in d.items():
            tol = FLOOR_TOL[m] if m in FLOOR_TOL and "subsampling" not in key else GOLDEN_TOL[m]
            # the card's floor-dominated metrics no further from the float64
            # oracle than the pins are
            closer = abs(got[m] - truth[key][m]) <= abs(pins[m] - truth[key][m]) + GOLDEN_TOL[m]
            if not abs(v) < tol or not closer:
                off[f"{key}.{m}"] = v
    log(f"[families] kernel launches {launches} (expected {want})")
    if off or launches != want or list(r["averaged"]) != list(GOLDEN_FAMILIES):
        raise AssertionError(f"families run off the golden pins: {off}; launches {launches} (expected {want})")
    return launches


def _nvsr_testee(cls_name, device="cuda", **kw):
    from ssr_eval_tpu_torch.models import testees

    return getattr(testees, cls_name)(model_name="unet", seed=NVSR_SEED, device=device, **kw)


def _nvsr_helper(testee, root, cutoffs, batch, device=None, name="chip_nvsr"):
    import ssr_eval_tpu_torch

    return ssr_eval_tpu_torch.SSR_Eval_Helper(
        testee, input_sr=SR, output_sr=SR, evaluation_sr=SR, test_name=name, test_data_root=root,
        setting_fft={"cutoff_freq": cutoffs}, auto_download=False, batch_size=batch, device=device,
    )


def _max_pair_delta(a, b, keys=METRICS):
    pa, pb = _pairs(a), _pairs(b)
    if not pa or set(pa) != set(pb):
        raise AssertionError("two runs scored different (file, spec) pairs")
    finite = all(math.isfinite(pa[p][k]) for p in pa for k in keys)
    return {k: max(abs(pa[p][k] - pb[p][k]) for p in pa) for k in keys}, finite


def _free_card():
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_nvsr(work):
    """The full-width NVSR testee through SSR_Eval_Helper on the card."""
    import torch

    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel
    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.io.audio import write_wav
    from ssr_eval_tpu_torch.models.nvsr import get_n_params
    from ssr_eval_tpu_torch.utils.bucket import bucket_length
    from ssr_eval_tpu_torch.utils.flops import chip_peaks, count_cost, utilization
    from ssr_eval_tpu_torch.utils.profiling import StageTimers

    root = os.path.join(work, "sweep_data")
    n_batches = -(-N_UTTS // NVSR_BATCH)
    t = time.perf_counter()
    testee = _nvsr_testee("NVSRTestee")
    n_unet = get_n_params(testee.model.generator)
    n_all = get_n_params(testee.model)
    log(f"[nvsr] NVSRTestee('unet') built on the card in {time.perf_counter() - t:.2f} s: "
        f"generator {n_unet} parameters, vocoder {n_all - n_unet}, total {n_all}")
    if not UNET_PARAMS[0] < n_unet < UNET_PARAMS[1]:
        raise AssertionError(f"the UNet holds {n_unet} parameters, expected {UNET_PARAMS}")

    helper = _nvsr_helper(testee, root, NVSR_CUTOFFS, NVSR_BATCH)
    t = time.perf_counter()
    helper.evaluate(verbose=False)  # warm: allocator, cuDNN plans, constants
    warm_s = time.perf_counter() - t
    helper.engine.stats = StageTimers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2):
        if i == 0:
            stft_magnitude_kernel.launches = 0
        t = time.perf_counter()
        res = helper.evaluate(verbose=False)
        times.append(time.perf_counter() - t)
        if i == 0:
            card, launches = res, stft_magnitude_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    want = n_batches * (1 + 2 * len(NVSR_CUTOFFS))
    if launches != want:
        raise AssertionError(f"|STFT| kernel launched {launches} times in the NVSR sweep, expected {want}")
    pairs = _pairs(card)
    if len(pairs) != N_UTTS * len(NVSR_CUTOFFS) or not all(
        math.isfinite(m[k]) for m in pairs.values() for k in METRICS
    ):
        raise AssertionError("the NVSR sweep did not score every (file, spec) pair with finite metrics")

    # FLOP of one spec's infer_batch at the main path's shapes (utils.flops:
    # FlopCounterMode's convolutions and matmuls, torch.fft ops and the
    # |STFT| kernel by their analytic formula)
    lmax = int(UTT_SECONDS * SR)
    xb = torch.zeros(NVSR_BATCH, bucket_length(lmax), device=testee.device)
    nb = torch.full((NVSR_BATCH,), lmax, device=testee.device)
    cost = count_cost(testee.infer_batch, xb, nb)
    flops_batch = cost["flops"] * len(NVSR_CUTOFFS)
    best = min(times)
    log(
        f"[nvsr] {N_UTTS} utts x {len(NVSR_CUTOFFS)} cutoffs, batch {NVSR_BATCH}: warm-up {warm_s:.3f} s; "
        f"timed runs {[round(x, 4) for x in times]} s; best {best / n_batches:.4f} s/batch, {N_UTTS / best:.2f} utt/s; "
        f"kernel launches {launches} (1 + 2 x {len(NVSR_CUTOFFS)} per batch); "
        f"max_memory_allocated {peak / 2**30:.3f} GiB"
    )
    log(f"[nvsr] model FLOP per batch (utils.flops.count_cost over one spec's infer_batch at [{NVSR_BATCH}, "
        f"{xb.shape[1]}], x {len(NVSR_CUTOFFS)} specs): {flops_batch:.4e} (convolutions and matmuls "
        f"{cost['matmul_conv_flops'] * len(NVSR_CUTOFFS):.4e}, torch.fft {cost['fft_flops'] * len(NVSR_CUTOFFS):.4e}, "
        f"|STFT| kernel {cost['kernel_flops'] * len(NVSR_CUTOFFS):.4e}); at the best batch time "
        f"{flops_batch / (best / n_batches) / 1e12:.2f} TFLOP/s; fp32 peak bound "
        f"{flops_batch / FP32_FLOP_PER_S:.4f} s/batch; utilization "
        f"{json.dumps(utilization(flops_batch, cost['bytes_accessed'] * len(NVSR_CUTOFFS), n_batches / best, chip_peaks()))}")
    log("[nvsr] stages over the 2 timed runs:", json.dumps(helper.engine.stats.summary()))
    profile_sweep(helper, tag="nvsr-profile")
    log("[nvsr] averaged:", json.dumps(card["averaged"]))

    # the post-processing testee on the first utterances
    pp = _nvsr_testee("NVSRPostProcTestee")
    pp_helper = _nvsr_helper(pp, root, NVSR_CUTOFFS, NVSR_POSTPROC_UTTS, name="chip_nvsr_pp")
    stft_magnitude_kernel.launches = 0
    pp_res = pp_helper.evaluate(limit_test_nums=NVSR_POSTPROC_UTTS, verbose=False)
    pp_launches = stft_magnitude_kernel.launches
    pp_want = 1 + 3 * len(NVSR_CUTOFFS)
    log(f"[nvsr] NVSRPostProcTestee on {NVSR_POSTPROC_UTTS} utterances: kernel launches {pp_launches} "
        f"(expected {pp_want}); averaged {json.dumps(pp_res['averaged'])}")
    if pp_launches != pp_want or len(_pairs(pp_res)) != NVSR_POSTPROC_UTTS * len(NVSR_CUTOFFS):
        raise AssertionError(f"NVSRPostProcTestee: {pp_launches} launches (expected {pp_want})")
    del pp, pp_helper
    _free_card()

    # card vs CPU, the same seeded weights, two short utterances
    short = os.path.join(work, "nvsr_short")
    os.makedirs(os.path.join(short, "p000"))
    for i in range(2):
        write_wav(os.path.join(short, "p000", f"s{i}.wav"), speechlike(NVSR_SHORT_SECONDS, SR, seed=2000 + i), SR)
    card_short = _nvsr_helper(testee, short, NVSR_CUTOFFS, 2, name="chip_nvsr_short").evaluate(verbose=False)
    cpu_testee = _nvsr_testee("NVSRTestee", device="cpu")
    t = time.perf_counter()
    cpu_short = _nvsr_helper(cpu_testee, short, NVSR_CUTOFFS, 2, device="cpu",
                             name="chip_nvsr_short_cpu").evaluate(verbose=False)
    cpu_s = time.perf_counter() - t
    delta, finite = _max_pair_delta(card_short, cpu_short)
    delta["log_sispec_cos"] = cos_delta(card_short, cpu_short)
    x = np.zeros((2, bucket_length(int(NVSR_SHORT_SECONDS * SR))), np.float32)
    for i in range(2):
        x[i, : int(NVSR_SHORT_SECONDS * SR)] = speechlike(NVSR_SHORT_SECONDS, SR, seed=2000 + i)
    n = torch.full((2,), int(NVSR_SHORT_SECONDS * SR))
    y_card, _ = testee.infer_batch(torch.from_numpy(x).to(testee.device), n.to(testee.device))
    y_cpu, _ = cpu_testee.infer_batch(torch.from_numpy(x), n)
    delta["wave"] = ((y_card.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    log(f"[nvsr] card vs CPU, 2 x {NVSR_SHORT_SECONDS} s x {len(NVSR_CUTOFFS)} cutoffs (CPU run {cpu_s:.2f} s): "
        f"max |card - CPU| per pair and max |dwave| / max |wave|: {json.dumps(delta)}")
    if not finite or any(not delta[k] <= NVSR_CARD_VS_CPU[k] for k in NVSR_CARD_VS_CPU):
        raise AssertionError(f"NVSR card vs CPU failed: {delta} (limits {NVSR_CARD_VS_CPU}, finite={finite})")
    del cpu_testee
    _free_card()

    trained_lsd = phase_nvsr_trained(short)

    # bf16 against this fp32 run on the sweep data
    d_bf, finite, bf_warm, bf_s = nvsr_bf16_vs_fp32(root, card)
    log(f"[nvsr] bf16: warm-up {bf_warm:.3f} s, timed {bf_s:.4f} s ({bf_s / n_batches:.4f} s/batch, "
        f"{N_UTTS / bf_s:.2f} utt/s) vs fp32 best {best / n_batches:.4f} s/batch; "
        f"max |bf16 - fp32| per pair: {json.dumps(d_bf)}")
    over = bf16_over(d_bf, finite)
    if over:
        raise AssertionError(f"bf16 off fp32 by {d_bf} in {over} (limits {NVSR_BF16}, LSD {NVSR_BF16_LSD}; "
                             f"finite={finite})")
    del testee, helper
    _free_card()
    return launches, trained_lsd


def cos_delta(a, b):
    """max per (file, spec) pair of |sispec_cos(a) - sispec_cos(b)| of
    log-SiSpec, for two runs that scored the same pairs."""
    pa, pb = _pairs(a), _pairs(b)
    return max(abs(sispec_cos(pa[p]["log_sispec"]) - sispec_cos(pb[p]["log_sispec"])) for p in pb)


def sispec_cos(db):
    """|cos t| of a SiSpec in dB, 10 log10(cos^2 t / sin^2 t), t the angle
    between the estimate's and the target's (log-)magnitude spectrograms."""
    r = 10.0 ** (db / 10.0)
    return math.sqrt(r / (1.0 + r))


def nvsr_bf16_vs_fp32(root, res_fp, seed=NVSR_SEED, base=None):
    """NVSRTestee("unet") in bf16 with `seed`'s weights (or `base`'s)
    through the helper on the sweep data at NVSR_CUTOFFS, against the fp32
    run `res_fp`: (max per-pair |bf16 - fp32| of the four metrics and of
    log-SiSpec's |cos t| ("log_sispec_cos"), finite, warm-up s, timed s)."""
    import torch

    from ssr_eval_tpu_torch.models.testees import NVSRTestee

    bf = NVSRTestee(model_name="unet", seed=seed, device="cuda", dtype=torch.bfloat16)
    if base is not None:
        bf._set_base(base)
    helper = _nvsr_helper(bf, root, NVSR_CUTOFFS, NVSR_BATCH, name="chip_nvsr_bf16")
    t = time.perf_counter()
    helper.evaluate(verbose=False)
    warm = time.perf_counter() - t
    t = time.perf_counter()
    res_bf = helper.evaluate(verbose=False)
    timed = time.perf_counter() - t
    d, finite = _max_pair_delta(res_bf, res_fp)
    if finite:
        d["log_sispec_cos"] = cos_delta(res_bf, res_fp)
    del bf, helper
    _free_card()
    return d, finite, warm, timed


def bf16_over(d, finite):
    """The NVSR_BF16 limits (and NVSR_BF16_LSD) that `d` exceeds."""
    if not finite:
        return ["finite"]
    return [k for k in NVSR_BF16 if not d[k] <= NVSR_BF16[k]] + (["lsd_jax"] if not d["lsd"] <= NVSR_BF16_LSD else [])


def phase_nvsr_trained(root):
    """examples/trained_small on the card: the .npz generator and the .pt
    vocoder load, the vocoder passes its sanity check, and the
    NVSRPostProcTestee sweep beats the identity testee at every cutoff."""
    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch.models.testees import NVSRPostProcTestee
    from ssr_eval_tpu_torch.models.vocoder_check import synthesis_report

    art = os.path.join(ROOT, "examples", "trained_small")
    t = NVSRPostProcTestee(model_name="dnn", device="cuda")
    t.load_generator_checkpoint(os.path.join(art, "generator_dnn.npz"))
    unmatched = t.load_vocoder_checkpoint(os.path.join(art, "vocoder_small_trained.pt"), check=True)
    rep = synthesis_report(t.model)
    got = _nvsr_helper(t, root, TRAINED_CUTOFFS, 2, name="chip_trained").evaluate(verbose=False)
    ident = _nvsr_helper(ssr_eval_tpu_torch.BatchedTestee(), root, TRAINED_CUTOFFS, 2,
                         name="chip_identity").evaluate(verbose=False)
    lsd = {k: (got["averaged"][k]["lsd"], ident["averaged"][k]["lsd"]) for k in ident["averaged"]}
    log(f"[nvsr] trained_small on the card: unmatched {unmatched}, vocoder check {json.dumps(rep)}; "
        f"LSD (trained, identity) per cutoff {json.dumps(lsd)}")
    if unmatched or rep["corr"] <= 0.5 or len(lsd) != len(TRAINED_CUTOFFS) or not all(a < b for a, b in lsd.values()):
        raise AssertionError(f"trained_small on the card failed: {lsd}, {rep}, unmatched {unmatched}")
    return lsd


def bwd_bound(B, ext_len, mf, n_fft):
    """Least time for the |STFT| backward call on this card: bytes (ext and
    the upstream gradient read once, the gradient of ext written once) vs
    two FFT-class transforms per frame (2 x 2.5 N log2 N) and ~10
    operations per bin for H = g X / |X| (utils.flops's formula)."""
    from ssr_eval_tpu_torch.utils.flops import stft_magnitude_backward_cost

    flops, nbytes = stft_magnitude_backward_cost(B, ext_len, mf, n_fft)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def phase_backward_kernel():
    """The |STFT| backward kernel against its plain version (torch autograd
    on the card) and a float64 CPU autograd; kernel, plain and the backward
    of torch.stft(...).abs() (a yardstick the port never calls) timed on
    the same saved graphs; row 0 alone vs in the batch, bit for bit."""
    import torch

    from ssr_eval_tpu_torch.device import resolve_device
    from ssr_eval_tpu_torch.dsp.spectral import window_tensor
    from ssr_eval_tpu_torch.dsp.stft_kernel import (
        _backward,
        _backward_plan,
        _fft_plan,
        stft_magnitude_backward_kernel,
        stft_magnitude_backward_plain,
        stft_magnitude_plain,
    )

    dev = resolve_device()
    g = torch.Generator(device=dev).manual_seed(1)
    shapes = []
    for B, mf, n_fft, hop in BWD_SHAPES:
        ext_len = (mf - 1) * hop + n_fft
        ext = 0.1 * torch.randn(B, ext_len, generator=g, device=dev)
        gm = torch.randn(B, mf, n_fft // 2 + 1, generator=g, device=dev)
        win = window_tensor(n_fft, n_fft, dev)
        got = stft_magnitude_backward_kernel(ext, gm, n_fft, hop, mf, win)
        torch.cuda.synchronize()
        want = stft_magnitude_backward_plain(ext, gm, n_fft, hop, mf, win)
        ref = stft_magnitude_backward_plain(ext.cpu().double(), gm.cpu().double(), n_fft, hop, mf, win.cpu().double())
        peak = ref.abs().max().item()
        max_abs = (got - want).abs().max().item()
        rel = max_abs / want.abs().max().item()
        rel64 = (got.cpu().double() - ref).abs().max().item() / peak
        plain_rel64 = (want.cpu().double() - ref).abs().max().item() / peak
        del ref
        if got.shape != ext.shape or not rel <= BWD_PLAIN_TOL or not rel64 <= BWD_TOL:
            raise AssertionError(
                f"stft backward kernel [{B}, {mf}] {n_fft}/{hop}: vs plain {rel:.3e} (limit {BWD_PLAIN_TOL}), "
                f"vs float64 {rel64:.3e} (limit {BWD_TOL})"
            )
        # row 0 alone and in the batch, at the kernel's S and at BWD_FORCED
        invariant = None
        if (n_fft, hop) in ((2048, 441), (2229, 480)) and B > 1:
            one = stft_magnitude_backward_kernel(ext[:1].contiguous(), gm[:1].contiguous(), n_fft, hop, mf, win)
            forced = [_backward(ext, gm, n_fft, hop, mf, win, s) for s in BWD_FORCED]
            invariant = all(torch.equal(x[:1], one) for x in [got, *forced])
            if not invariant:
                raise AssertionError(f"stft backward [{B}, {mf}] {n_fft}/{hop}: row 0 alone differs from row 0 "
                                     f"in the batch (auto, {BWD_FORCED})")
        e = ext.clone().requires_grad_(True)
        m_plain = stft_magnitude_plain(e, n_fft, hop, mf, win)
        m_lib = torch.stft(e, n_fft, hop, window=win, center=False, return_complex=True).abs()
        g_lib = gm.transpose(1, 2)
        ms = cuda_ms(lambda: stft_magnitude_backward_kernel(ext, gm, n_fft, hop, mf, win))
        forced_ms = {s: cuda_ms(lambda: _backward(ext, gm, n_fft, hop, mf, win, s)) for s in BWD_FORCED}
        plain_ms = cuda_ms(lambda: torch.autograd.grad(m_plain, e, gm, retain_graph=True))
        library_ms = cuda_ms(lambda: torch.autograd.grad(m_lib, e, g_lib, retain_graph=True))
        del m_plain, m_lib
        bound_ms, bound_by, nbytes, flops = bwd_bound(B, ext_len, mf, n_fft)
        plan = _fft_plan(n_fft)
        s = dict(
            n_fft=n_fft, hop=hop, shape=[B, mf, n_fft // 2 + 1], ext_len=ext_len, path=plan.kind,
            fft_len=plan.fft_len, seg_frames=_backward_plan(B, ext_len, n_fft, hop, mf),
            max_abs_err=max_abs, max_rel_err=rel, max_rel_err_f64=rel64, plain_max_rel_err_f64=plain_rel64,
            ms=ms, ms_at_seg_frames=forced_ms,
            plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
            flops=flops, row_alone_equals_in_batch=invariant,
        )
        log("[train-kernel]", json.dumps(s))
        shapes.append(s)
    return shapes


def _metric_stft(x, lens, cfg, mf):
    """|STFT| of [B, L] buffers as spectral_metrics computes it: through the
    kernel wrapper in float32, through its plain version in float64 (the
    wrapper takes float32 only)."""
    import torch

    from ssr_eval_tpu_torch.dsp import spectral
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_plain

    if x.dtype != torch.float64:
        return spectral.stft_magnitude(x, lens, cfg, mf)
    win = torch.from_numpy(spectral._padded_window64(cfg.n_fft, cfg.win))
    return stft_magnitude_plain(spectral._framing_source(x, lens, cfg, mf), cfg.n_fft, cfg.hop, mf, win)


def _lsd_of(est, tgt, lens, cfg, mf, keep=None):
    """The metric LSD of [B, L] buffers, the estimate's bins outside `keep`
    [B, F, K] held constant: no gradient flows through them."""
    import torch

    from ssr_eval_tpu_torch.dsp import spectral
    from ssr_eval_tpu_torch.metrics.kernels import _lsd

    est_sp, tgt_sp = _metric_stft(est, lens, cfg, mf), _metric_stft(tgt, lens, cfg, mf)
    if keep is not None:
        est_sp = torch.where(keep, est_sp, est_sp.detach())
    nf = spectral.n_frames_for_length(cfg, lens)
    return _lsd(est_sp, tgt_sp, (torch.arange(mf, device=est.device)[None, :] < nf[:, None]).to(est.dtype))


def phase_metric_gradient():
    """d sum(LSD) / d estimate at the 48 kHz metric STFT (2229/480, the
    Bluestein backward) for 2 utterances, the estimate the target plus a
    broadband floor (as the sweep's testee): on the card (one backward
    launch each) and on the CPU, each against a float64 CPU autograd.  The
    whole gradient through spectral_metrics, and the same gradient with the
    estimate's bins below LSD_GRAD_FLOOR x their frame's rms held constant
    (see LSD_GRAD_FLOOR)."""
    import torch

    from ssr_eval_tpu_torch.device import resolve_device
    from ssr_eval_tpu_torch.dsp import spectral
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_backward_kernel
    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.metrics.kernels import metric_stft_config, spectral_metrics

    sr = 48000
    cfg = metric_stft_config(sr)
    lens = [int(LSD_GRAD_SECONDS * sr), int(0.8 * LSD_GRAD_SECONDS * sr)]
    tgt = np.zeros((2, lens[0]), np.float32)
    for i, n in enumerate(lens):
        tgt[i, :n] = speechlike(n / sr, sr, seed=6000 + i)[:n]
    noise = (1e-3 * np.random.default_rng(NOISE_SEED).standard_normal(tgt.shape)).astype(np.float32)
    est = (tgt + noise * (np.arange(lens[0])[None, :] < np.asarray(lens)[:, None])).astype(np.float32)
    mf = cfg.max_frames(lens[0])
    # float64: the whole gradient, the bins held and the held gradient
    n64, t64 = torch.tensor(lens), torch.from_numpy(tgt).double()
    e64 = torch.from_numpy(est).double().requires_grad_(True)
    _lsd_of(e64, t64, n64, cfg, mf).sum().backward()
    g64 = e64.grad
    with torch.no_grad():
        sp64 = _metric_stft(e64, n64, cfg, mf)
    keep = sp64 >= LSD_GRAD_FLOOR * sp64.pow(2).mean(-1, keepdim=True).sqrt()
    frames = (torch.arange(mf)[None, :] < spectral.n_frames_for_length(cfg, n64)[:, None])[:, :, None]
    held = (frames & ~keep).sum().item() / (frames.sum().item() * cfg.n_bins)
    e64.grad = None
    _lsd_of(e64, t64, n64, cfg, mf, keep).sum().backward()
    h64 = e64.grad
    grads = {}
    for dev in ("card", "cpu"):
        d = resolve_device() if dev == "card" else torch.device("cpu")
        n, t = torch.tensor(lens, device=d), torch.from_numpy(tgt).to(d)
        e = torch.from_numpy(est).to(d).requires_grad_(True)
        before = stft_magnitude_backward_kernel.launches
        lsd = spectral_metrics(e, n, t, n, cfg, mf)["lsd"]
        lsd.sum().backward()
        whole = e.grad.cpu().double()
        e.grad = None
        _lsd_of(e, t, n, cfg, mf, keep.to(d)).sum().backward()
        grads[dev] = (whole, e.grad.cpu().double(), lsd.detach().cpu(), stft_magnitude_backward_kernel.launches - before)
    (g_card, h_card, lsd_card, n_card), (g_cpu, h_cpu, lsd_cpu, n_cpu) = grads["card"], grads["cpu"]

    def err(a, b):  # max|a - b| / max|b|
        return ((a - b).abs().max() / b.abs().max()).item()

    r = dict(
        held_bin_share=held,
        whole=dict(card_vs_f64=err(g_card, g64), cpu_vs_f64=err(g_cpu, g64), card_vs_cpu=err(g_card, g_cpu)),
        held=dict(card_vs_f64=err(h_card, h64), cpu_vs_f64=err(h_cpu, h64), card_vs_cpu=err(h_card, h_cpu)),
        lsd_card=lsd_card.tolist(), lsd_cpu=lsd_cpu.tolist(), launches_card=n_card, launches_cpu=n_cpu,
    )
    log(f"[train-lsd-grad] 48 kHz LSD {cfg.n_fft}/{cfg.hop}, 2 x {LSD_GRAD_SECONDS} s, bins below "
        f"{LSD_GRAD_FLOOR} x frame rms held: {json.dumps(r)} (limits: whole card_vs_f64 {LSD_GRAD_RATIO} x "
        f"cpu_vs_f64; held card_vs_f64 and card_vs_cpu {LSD_GRAD_TOL})")
    w, h = r["whole"], r["held"]
    if (not w["card_vs_f64"] <= LSD_GRAD_RATIO * w["cpu_vs_f64"] or not h["card_vs_f64"] <= LSD_GRAD_TOL
            or not h["card_vs_cpu"] <= LSD_GRAD_TOL or n_card != 2 or n_cpu != 0
            or not (torch.isfinite(g_card).all() and torch.isfinite(h_card).all())):
        raise AssertionError(f"48 kHz LSD gradient: {r}")
    return r


def gradient_case(kind, device, seed, init=None, dtype=None):
    """One of phase_train (d)'s two models on `device`: kind "generator"
    (a small UNet generator, NVSRTrainer.loss on fixed mel pairs) or
    "vocoder" (SMALL_TFGAN, VocoderTrainer.loss with the mel of speech-like
    crops as condition and target).  Weights: `init(model, seed)` on the CPU
    (default nvsr.init_weights), then moved, with the inputs, to `device`
    and `dtype` (default float32).  -> (model, the module at whose output
    the loss's cotangent is taken, a thunk computing the loss)."""
    import torch

    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.models import nvsr
    from ssr_eval_tpu_torch.models.train import NVSRTrainer
    from ssr_eval_tpu_torch.models.train_vocoder import SMALL_TFGAN, VocoderTrainer
    from ssr_eval_tpu_torch.models.unet import UNetRes

    init = init or nvsr.init_weights
    dtype = dtype or torch.float32
    if kind == "generator":
        with torch.device("meta"):
            gen = nvsr.Generator("unet")
        gen.analysis_module = UNetRes(channels=1, widths=(8, 16), blocks_per_group=2)
        gen = init(gen, seed).to(device, dtype).train()
        rng = np.random.default_rng(12)
        lr_np = np.abs(rng.standard_normal((2, 24, 128))).astype(np.float32) + np.float32(1e-3)
        hr_np = lr_np + np.float32(0.1) * np.abs(rng.standard_normal(lr_np.shape)).astype(np.float32)
        lr, hr = (torch.from_numpy(a).to(device, dtype) for a in (lr_np, hr_np))
        return gen, gen, lambda: NVSRTrainer.loss(gen, lr, hr)
    vt = VocoderTrainer(SMALL_TFGAN, device=device)
    vt.mel.to(dtype)
    model = init(vt.model, seed).to(vt.device, dtype).train()
    crops = np.stack([speechlike(VOC_CROP, SR, seed=5000 + i) for i in range(2)]).astype(np.float32)
    with torch.no_grad():
        cond = VocoderTrainer(SMALL_TFGAN, device="cpu").lin_mel(torch.from_numpy(crops)).to(vt.device, dtype)
    return model, vt.mel, lambda: vt.loss(model, cond, cond)


def _output_of(module, fn):
    """(fn(), the output of `module`'s last forward inside it; a dict's "mel")."""
    got = []
    handle = module.register_forward_hook(lambda m, i, o: got.append(o))
    try:
        value = fn()
    finally:
        handle.remove()
    return value, (got[-1]["mel"] if isinstance(got[-1], dict) else got[-1])


@contextlib.contextmanager
def pinned_branches(masks, record):
    """Inside, F.relu and F.leaky_relu take each element's branch from
    `masks`: appended (x >= 0, per call in call order) when `record`,
    replayed in the same order otherwise.  Recording computes what the two
    functions compute."""
    import torch
    import torch.nn.functional as F

    relu, leaky = F.relu, F.leaky_relu
    replay = iter(masks)

    def branch(x):
        if record:
            masks.append((x >= 0).detach().cpu())
            return masks[-1].to(x.device)
        m = next(replay, None)
        if m is None or m.shape != x.shape:
            raise AssertionError("the replayed forward calls its activations differently from the recorded one")
        return m.to(x.device)

    F.relu = lambda x, inplace=False: torch.where(branch(x), x, torch.zeros_like(x))
    F.leaky_relu = lambda x, negative_slope=0.01, inplace=False: torch.where(branch(x), x, x * negative_slope)
    try:
        yield
    finally:
        F.relu, F.leaky_relu = relu, leaky
    if not record and next(replay, None) is not None:
        raise AssertionError("the replayed forward called fewer activations than the recorded one")


def cotangent_grads(ref, *others):
    """The gradients of `ref`'s loss (a gradient_case) on its device, and
    of each other case's model from that loss's cotangent at the output
    (moved to the case's device and dtype), with every relu and leaky ReLU
    on the reference's branches (pinned_branches).  -> [grads of ref,
    *others]."""
    import torch

    masks = []
    with pinned_branches(masks, record=True):
        loss, out = _output_of(ref[1], ref[2])
    (cot,) = torch.autograd.grad(loss, out, retain_graph=True)
    out.backward(cot)
    grads = [_grads_of(ref[0])]
    for model, at, fn in others:
        with pinned_branches(masks, record=False):
            _, o = _output_of(at, fn)
        o.backward(cot.to(o.device, o.dtype))
        grads.append(_grads_of(model))
    return grads


def train_card_vs_cpu(dev):
    """phase_train (d): per model, the CPU's loss gradient against the card's
    backward from the CPU's cotangent on the CPU's branches ->
    {"generator": (delta, leaf), "vocoder": (delta, leaf)}, _leaf_delta
    with TRAIN_GRAD_FLOOR."""
    out = {}
    for kind, seed in (("generator", 11), ("vocoder", 13)):
        g_cpu, g_card = cotangent_grads(gradient_case(kind, "cpu", seed), gradient_case(kind, dev, seed))
        out[kind] = _leaf_delta(g_cpu, g_card, TRAIN_GRAD_FLOOR)
    return out


def _grads_of(model):
    return {k: p.grad.detach().clone() for k, p in model.named_parameters() if p.grad is not None}


def _leaf_delta(ref, got, floor):
    """max over leaves of max|got - ref| over the leaf's scale, max(its max,
    floor x the model's largest gradient) -> (value, leaf)."""
    if set(ref) != set(got):
        raise AssertionError("two steps produced gradients for different leaves")
    floor = floor * max(g.abs().max().item() for g in ref.values())
    worst, name = 0.0, None
    for k, r in ref.items():
        d = (got[k].to(r.device) - r).abs().max().item() / max(r.abs().max().item(), floor)
        if not math.isfinite(d) or d > worst:
            worst, name = (d if math.isfinite(d) else math.inf), k
    return worst, name


def phase_train(work):
    """NVSR training on the card: the backward kernel's checks, the
    full-width generator (and its remat step), the vocoder, and
    card-vs-CPU gradients."""
    import torch

    from ssr_eval_tpu_torch.device import resolve_device
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_backward_kernel, stft_magnitude_kernel
    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.models import nvsr
    from ssr_eval_tpu_torch.models.data import MelPairPipeline
    from ssr_eval_tpu_torch.models.testees import NVSRTestee
    from ssr_eval_tpu_torch.models.train import NVSRTrainer
    from ssr_eval_tpu_torch.models.train_vocoder import SMALL_TFGAN, VocoderTrainer, export_torch_state_dict
    from ssr_eval_tpu_torch.models.vocoder import TFGANConfig
    from ssr_eval_tpu_torch.models.vocoder_check import probe_signal, synthesis_report
    from ssr_eval_tpu_torch.utils.bucket import bucket_length
    from ssr_eval_tpu_torch.utils.flops import count_cost

    dev = resolve_device()
    bwd_shapes = phase_backward_kernel()
    phase_metric_gradient()
    launches = {}

    # (b) the full-width generator
    audios = [speechlike(2.0, SR, seed=s) for s in range(GEN_AUDIOS)]
    tr = NVSRTrainer(model_name="unet", learning_rate=GEN_LR)
    n_gen = nvsr.get_n_params(tr.model.generator)
    if not UNET_PARAMS[0] < n_gen < UNET_PARAMS[1]:
        raise AssertionError(f"the UNet holds {n_gen} parameters, expected {UNET_PARAMS}")
    ckpt = os.path.join(work, "nvsr_generator_ckpt")
    stft_magnitude_kernel.launches = stft_magnitude_backward_kernel.launches = 0
    t = time.perf_counter()
    state, fit_losses = tr.fit(audios, steps=GEN_FIT_STEPS, batch=GEN_BATCH, crop_seconds=GEN_CROP,
                               ckpt_path=ckpt, ckpt_every=GEN_FIT_STEPS, log_every=0, cutoffs=GEN_CUTOFFS)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t
    launches["train_generator"] = stft_magnitude_kernel.launches
    if stft_magnitude_kernel.launches != 2 * GEN_FIT_STEPS or stft_magnitude_backward_kernel.launches:
        raise AssertionError(f"generator fit: {stft_magnitude_kernel.launches} |STFT| launches (expected "
                             f"{2 * GEN_FIT_STEPS}), {stft_magnitude_backward_kernel.launches} backward (expected 0)")
    # the checkpoint written at the last fit step reloads into the testee
    testee = NVSRTestee(model_name="unet")
    testee.load_generator_checkpoint(ckpt + ".npz")
    live = state["model"].state_dict()
    same = all(torch.equal(v, live[k]) for k, v in testee.model.generator.state_dict().items())
    short = int(NVSR_SHORT_SECONDS * SR)
    xb = np.zeros((2, bucket_length(short)), np.float32)
    for i in range(2):
        xb[i, :short] = speechlike(NVSR_SHORT_SECONDS, SR, seed=3000 + i)
    y, _ = testee.infer_batch(torch.from_numpy(xb).to(dev), torch.full((2,), short, device=dev))
    finite = bool(torch.isfinite(y).all()) and float(y.abs().max()) > 0
    log(f"[train] NVSRTrainer('unet'): {n_gen} parameters; fit {GEN_FIT_STEPS} steps in {fit_s:.3f} s "
        f"(batch {GEN_BATCH} x {GEN_CROP} s, includes the first step's cuDNN set-up), losses "
        f"{[round(x, 5) for x in fit_losses]}; checkpoint reloads into NVSRTestee('unet') "
        f"{'identical' if same else 'DIFFERENT'}, infer_batch finite {finite}")
    if not same or not finite or not all(math.isfinite(x) for x in fit_losses):
        raise AssertionError("generator fit or its checkpoint failed")
    del testee, y
    _free_card()

    pipe = MelPairPipeline(crop_seconds=GEN_CROP, cutoffs=GEN_CUTOFFS)
    mel_lr, mel_hr = pipe.make_pair(pipe.random_crops(audios, np.random.default_rng(123), GEN_BATCH), 1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(GEN_FIXED_STEPS):
        t = time.perf_counter()
        state, loss = tr.step(state, mel_lr, mel_hr)
        losses.append(float(loss))  # synchronises
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    flops = count_cost(tr.step, state, mel_lr, mel_hr)["flops"]
    busy = profile_call(lambda: [tr.step(state, mel_lr, mel_hr) for _ in range(2)], "train-profile", keep="stft_")
    best, median = min(times), sorted(times)[len(times) // 2]
    # the profiler slows the host; against the unprofiled median step
    idle = None if busy is None else 1 - busy / 2e3 / median
    log(f"[train] fixed batch [{GEN_BATCH}, {mel_lr.shape[1]}, {mel_lr.shape[2]}], {GEN_FIXED_STEPS} steps: losses "
        f"{[round(x, 5) for x in losses]}; s/step {[round(x, 4) for x in times]} (best {best:.4f}, median "
        f"{median:.4f}); FLOP/step (utils.flops.count_cost) {flops:.4e}, "
        f"{flops / best / 1e12:.2f} TFLOP/s at the best step (fp32 peak bound {flops / FP32_FLOP_PER_S:.4f} s); "
        f"max_memory_allocated {peak / 2**30:.3f} GiB; idle share against the unprofiled median step {idle}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise AssertionError(f"the full-width generator's fixed-batch loss did not fall: {losses}")
    del tr, state
    _free_card()
    gen_times = times
    phase_remat(mel_lr, mel_hr, peak, median)
    del pipe, mel_lr, mel_hr
    _free_card()

    # (c) the small vocoder, then the full-width one for a few steps
    vt = VocoderTrainer(SMALL_TFGAN, learning_rate=VOC_LR)
    stft_magnitude_kernel.launches = stft_magnitude_backward_kernel.launches = 0
    t = time.perf_counter()
    vstate, vlosses = vt.fit(audios, steps=VOC_STEPS, batch=VOC_BATCH, crop_seconds=VOC_CROP, log_every=0)
    torch.cuda.synchronize()
    voc_s = time.perf_counter() - t
    launches["train_vocoder"] = stft_magnitude_kernel.launches
    bwd_launches = stft_magnitude_backward_kernel.launches
    corr = vt.probe_corr(vstate["model"], probe_signal(SR))
    path = os.path.join(work, "vocoder_small.pt")
    export_torch_state_dict(vstate["model"], SMALL_TFGAN, path)
    reload = NVSRTestee(model_name="dnn")
    unmatched = reload.load_vocoder_checkpoint(path, check=False)
    rep = synthesis_report(reload.model)
    head, tail = float(np.mean(vlosses[:5])), float(np.mean(vlosses[-5:]))
    log(f"[train] VocoderTrainer(SMALL_TFGAN): {VOC_STEPS} steps (batch {VOC_BATCH} x {VOC_CROP} s) in {voc_s:.3f} s "
        f"({voc_s / VOC_STEPS:.4f} s/step); loss mean of the first / last 5 steps {head:.5f} / {tail:.5f}; "
        f"|STFT| launches {launches['train_vocoder']} (2 per step), backward {bwd_launches} (1 per step); "
        f"probe_corr {corr:.4f}; exported and reloaded with load_vocoder_checkpoint(check=False): unmatched "
        f"{unmatched}, synthesis_report {json.dumps(rep)}")
    if (bwd_launches != VOC_STEPS or launches["train_vocoder"] != 2 * VOC_STEPS or not tail < head
            or unmatched or not rep["finite"]):
        raise AssertionError("vocoder training: the loss did not fall or the launch counts are off")
    del vt, vstate, reload
    _free_card()

    vt = VocoderTrainer(TFGANConfig(channels=VOC_FULL_CHANNELS), learning_rate=VOC_LR)
    vstate = vt.init_state(seed=1)
    crops = np.stack([speechlike(VOC_CROP, SR, seed=4000 + i) for i in range(VOC_BATCH)]).astype(np.float32)
    with torch.no_grad():
        cond = vt.lin_mel(torch.from_numpy(crops).to(dev))
    vt.step(vstate, cond, cond)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    full_times = []
    for _ in range(VOC_FULL_STEPS):
        t = time.perf_counter()
        _, loss = vt.step(vstate, cond, cond)
        float(loss)
        full_times.append(time.perf_counter() - t)
    log(f"[train] VocoderTrainer(TFGANConfig()) ({VOC_FULL_CHANNELS} channels, {nvsr.get_n_params(vt.model)} parameters), batch "
        f"{VOC_BATCH} x {VOC_CROP} s: s/step {[round(x, 4) for x in full_times]}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del vt, vstate, cond
    _free_card()

    # (d) card vs CPU: one backward of each small model
    before = stft_magnitude_backward_kernel.launches
    d = train_card_vs_cpu(dev)
    (d_gen, k_gen), (d_voc, k_voc) = d["generator"], d["vocoder"]
    log(f"[train] card vs CPU, one backward from the CPU loss's cotangent (max over leaves of max|card - CPU| / "
        f"leaf scale): small UNet generator {d_gen:.3e} ({k_gen}), SMALL_TFGAN vocoder {d_voc:.3e} ({k_voc}); "
        f"limits {TRAIN_CARD_VS_CPU}")
    if (not d_gen <= TRAIN_CARD_VS_CPU["generator"] or not d_voc <= TRAIN_CARD_VS_CPU["vocoder"]
            or stft_magnitude_backward_kernel.launches != before + 1):
        raise AssertionError(f"train card vs CPU failed: generator {d_gen} ({k_gen}), vocoder {d_voc} ({k_voc})")
    launches["train_vocoder_backward"] = bwd_launches
    return launches, bwd_shapes, gen_times


def phase_train_small(work, jax_trained_lsd):
    """The small NVSR trained on the card by the port's recipe, then
    scored as the JAX-trained artifacts are."""
    import torch

    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_backward_kernel, stft_magnitude_kernel
    from ssr_eval_tpu_torch.examples.train_small_nvsr import VOCODER_CHUNK, train_small_nvsr
    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.models.testees import NVSRPostProcTestee, NVSRTestee
    from ssr_eval_tpu_torch.utils.bucket import bucket_length

    out = os.path.join(work, "train_small")
    v_cap, g_steps = TRAIN_SMALL_STEPS
    stft_magnitude_kernel.launches = stft_magnitude_backward_kernel.launches = 0
    t = time.perf_counter()
    res = train_small_nvsr(out, v_cap, g_steps, check=True, log_every=0)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t
    launches = {"train_small": stft_magnitude_kernel.launches,
                "train_small_backward": stft_magnitude_backward_kernel.launches}
    v_run, chunks = res["report"]["vocoder_steps_run"], len(res["probe_corr"])
    want = {"train_small": 2 * v_run + 2 * chunks + 2 * g_steps + 4, "train_small_backward": v_run}
    vl, gl = res["vocoder_losses"], res["generator_losses"]
    falls = {k: (float(np.mean(x[:5])), float(np.mean(x[-5:]))) for k, x in (("vocoder", vl), ("generator", gl))}
    sec = res["seconds"]
    rep = res["report"]["vocoder_sanity"]
    log(f"[train_small] recipe on the card in {total_s:.2f} s: vocoder {v_run} steps (cap {v_cap}, chunks of "
        f"{VOCODER_CHUNK}) in {sec['vocoder']:.2f} s ({sec['vocoder'] / v_run:.4f} s/step, probe included), probe_corr "
        f"after each chunk {json.dumps(res['probe_corr'])}; generator {g_steps} steps in {sec['generator']:.2f} s "
        f"({sec['generator'] / g_steps:.4f} s/step); loss mean of the first / last 5 steps {json.dumps(falls)}, "
        f"final vocoder {vl[-1]:.5f}, generator {gl[-1]:.5f}; assembled with the vocoder check on: "
        f"{json.dumps(rep)}; |STFT| launches {json.dumps(launches)} (expected {json.dumps(want)})")
    if launches != want or not all(math.isfinite(x) for x in vl + gl) or not all(b < a for a, b in falls.values()):
        raise AssertionError(f"train_small: losses {falls} or launches {launches} (expected {want}) are off")

    # the card-trained post-processing testee against the identity testee,
    # on the data phase_nvsr_trained scored the JAX-trained artifacts on
    short = os.path.join(work, "nvsr_short")
    pp = NVSRPostProcTestee(model_name="dnn")
    pp.load_generator_checkpoint(res["paths"]["generator"])
    unmatched = pp.load_vocoder_checkpoint(res["paths"]["vocoder"], check=True)
    got = _nvsr_helper(pp, short, TRAINED_CUTOFFS, 2, name="chip_train_small").evaluate(verbose=False)
    ident = _nvsr_helper(ssr_eval_tpu_torch.BatchedTestee(), short, TRAINED_CUTOFFS, 2,
                         name="chip_train_small_identity").evaluate(verbose=False)
    lsd = {k: (got["averaged"][k]["lsd"], ident["averaged"][k]["lsd"]) for k in ident["averaged"]}
    log(f"[train_small] LSD per cutoff (card-trained, identity): {json.dumps(lsd)}; the JAX-trained "
        f"examples/trained_small (trained, identity): {json.dumps(jax_trained_lsd)}")
    if unmatched or len(lsd) != len(TRAINED_CUTOFFS) or not all(a < b for a, b in lsd.values()):
        raise AssertionError(f"the card-trained testee does not beat the identity testee: {lsd}, unmatched {unmatched}")

    # the card-trained testee on the card and on the CPU
    cpu = NVSRTestee(model_name="dnn", device="cpu")
    cpu.load_generator_checkpoint(res["paths"]["generator"])
    cpu.load_vocoder_checkpoint(res["paths"]["vocoder"], check=False)
    n = int(NVSR_SHORT_SECONDS * SR)
    x = np.zeros((2, bucket_length(n)), np.float32)
    for i in range(2):
        x[i, :n] = speechlike(NVSR_SHORT_SECONDS, SR, seed=6000 + i)
    card = res["testee"]
    y_card, _ = card.infer_batch(torch.from_numpy(x).to(card.device), torch.full((2,), n, device=card.device))
    y_cpu, _ = cpu.infer_batch(torch.from_numpy(x), torch.full((2,), n))
    wave = ((y_card.cpu() - y_cpu).abs().max() / y_cpu.abs().max()).item()
    log(f"[train_small] card vs CPU, the card-trained NVSRTestee on 2 x {NVSR_SHORT_SECONDS} s: max |dwave| / max "
        f"|wave| {wave:.3e} (limit {NVSR_CARD_VS_CPU['wave']})")
    if not wave <= NVSR_CARD_VS_CPU["wave"] or not bool(torch.isfinite(y_card).all()):
        raise AssertionError(f"the card-trained testee: card vs CPU {wave}")
    del pp, cpu, card, res
    _free_card()
    return launches


def phase_remat(mel_lr, mel_hr, plain_peak, plain_median):
    """The full-width generator step with UNetRes(remat=True) against
    remat=False on one batch: the same numbers, less memory."""
    import torch

    from ssr_eval_tpu_torch.models.train import NVSRTrainer

    def trainer(remat):
        tr = NVSRTrainer(model_name="unet", learning_rate=GEN_LR)
        tr.model.generator.analysis_module.remat = remat
        return tr, tr.init_state(seed=0)

    def record(state, loss):
        gen = state["model"]
        out = {"loss": loss.detach().reshape(1).cpu()}
        out.update({f"grad/{k}": p.grad.detach().cpu() for k, p in gen.named_parameters()})
        out.update({f"stats/{k}": b.detach().cpu() for k, b in gen.named_buffers() if "running" in k})
        return out

    torch.backends.cudnn.deterministic = True
    try:
        tr, st = trainer(False)
        want = record(*tr.step(st, mel_lr, mel_hr))
        del tr, st
        _free_card()
        tr, st = trainer(True)
        got = record(*tr.step(st, mel_lr, mel_hr))
    finally:
        torch.backends.cudnn.deterministic = False
    worst, leaf = _leaf_delta(want, got, 0.0)
    n_exact = sum(torch.equal(want[k], got[k]) for k in want)
    del want, got
    # s/step and peak memory with remat, as the train phase measured them
    # without (the trainer's weights, gradients and AdamW moments included)
    tr.step(st, mel_lr, mel_hr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(REMAT_STEPS):
        t = time.perf_counter()
        _, loss = tr.step(st, mel_lr, mel_hr)
        float(loss)  # synchronises
        times.append(time.perf_counter() - t)
    peak = torch.cuda.max_memory_allocated()
    median = sorted(times)[len(times) // 2]
    log(f"[train] remat: UNetRes(remat=True) vs remat=False, one step from seed 0 on [{GEN_BATCH}, "
        f"{mel_lr.shape[1]}, {mel_lr.shape[2]}] (cudnn deterministic): loss, gradients and running statistics "
        f"{worst:.3e} of the leaf's own max ({leaf}); {n_exact} leaves bit-identical")
    log(f"[train] remat: max_memory_allocated {peak / 2**30:.3f} GiB (remat=False {plain_peak / 2**30:.3f} GiB, "
        f"{peak / plain_peak:.3f}x); s/step {[round(x, 4) for x in times]} (median {median:.4f}; remat=False "
        f"median {plain_median:.4f}, {median / plain_median:.3f}x)")
    if not worst <= REMAT_TOL:
        raise AssertionError(f"remat step off the plain step by {worst} ({leaf}, limit {REMAT_TOL})")
    del tr, st


def phase_utilities(work, sweep, flac):
    """The leaderboard, the engine's FLOP/byte accounting, the real-data
    runbook offline and on the synthetic set, and examples.test."""
    import urllib.request

    import torch

    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch import verify_real
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_kernel
    from ssr_eval_tpu_torch.examples import test as example_test
    from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk
    from ssr_eval_tpu_torch.harness.leaderboard import run_leaderboard
    from ssr_eval_tpu_torch.utils.flops import chip_peaks, engine_program_costs, utilization

    n_batches = -(-N_UTTS // BATCH)

    def systems(device):
        basic = ssr_eval_tpu_torch.BasicTestee()
        basic.device = device
        return {"Noisy": noisy_testee(torch.device(device))[0], "Unprocessed": basic}

    kw = dict(test_data_root=flac["root"], cutoffs_khz=LEADERBOARD_KHZ, batch_size=BATCH)
    stft_magnitude_kernel.launches = 0
    t = time.perf_counter()
    rows, md = run_leaderboard(systems("cuda"), **kw)
    card_s = time.perf_counter() - t
    launches = stft_magnitude_kernel.launches
    # the noise testee on the device: 1 + C per batch; the host testee
    # is scored per spec against its own target: 2 C
    want = n_batches * (1 + len(LEADERBOARD_KHZ)) + n_batches * 2 * len(LEADERBOARD_KHZ)
    t = time.perf_counter()
    cpu_rows, _ = run_leaderboard(systems("cpu"), device="cpu", **kw)
    cpu_s = time.perf_counter() - t
    delta = {name: max(abs(rows[name][c] - cpu_rows[name][c]) for c in rows[name]) for name in rows}
    finite = all(math.isfinite(v) for r in rows.values() for v in r.values())
    log(f"[utilities] run_leaderboard (noise testee, BasicTestee) at {LEADERBOARD_KHZ} kHz on the FLAC data: card "
        f"{card_s:.2f} s, CPU {cpu_s:.2f} s; |STFT| launches {launches} (expected {want}); max |card - CPU| per "
        f"row {json.dumps(delta)} (limits: Noisy {CARD_VS_CPU['lsd']}, Unprocessed {FLOOR_TOL['lsd']}); rows "
        f"{json.dumps(rows)}")
    for line in md.splitlines():
        log(f"[utilities] {line}")
    if (not finite or launches != want or delta["Noisy"] > CARD_VS_CPU["lsd"]
            or delta["Unprocessed"] > FLOOR_TOL["lsd"]):
        raise AssertionError(f"leaderboard card vs CPU failed: {delta}, launches {launches}, finite {finite}")

    # the sweep's batch program, counted on the card and on the CPU
    card_eng, cpu_eng = sweep["engines"]
    costs, cpu_costs = engine_program_costs(card_eng), engine_program_costs(cpu_eng)
    if not costs or set(costs) != set(cpu_costs):
        raise AssertionError(f"engine programs differ: {sorted(costs)} vs {sorted(cpu_costs)}")
    peaks = chip_peaks()
    for label, c in costs.items():
        cc = cpu_costs[label]
        rel = {k: abs(c[k] - cc[k]) / cc[k] for k in ("flops", "bytes_accessed")}
        u = utilization(c["flops"], c["bytes_accessed"], 1.0 / sweep["s_per_batch"], peaks)
        log(f"[utilities] engine_program_costs {label}: {json.dumps({k: c[k] for k in sorted(c)})}; card vs CPU "
            f"relative {json.dumps(rel)}; at the sweep's {sweep['s_per_batch']:.4f} s/batch: {json.dumps(u)}; "
            f"chip_peaks {json.dumps(peaks)}")
        if any(v > COST_TOL for v in rel.values()) or c["calls"] < 1:
            raise AssertionError(f"engine cost card vs CPU off by {rel} (limit {COST_TOL})")

    # the runbook offline: both stages SKIP, nothing fetched
    fetched = []

    def no_network(*a, **k):
        fetched.append(a)
        raise OSError("chip_smoke.py: no network")

    urlopen, urllib.request.urlopen = urllib.request.urlopen, no_network
    try:
        report_path = os.path.join(work, "verify_real_report.json")
        rc = verify_real.main(["--out", report_path])
    finally:
        urllib.request.urlopen = urlopen
    with open(report_path) as f:
        stages = json.load(f)["stages"]
    log(f"[utilities] verify_real.main offline: rc {rc}, stages {json.dumps(stages)}, fetch attempts {len(fetched)}")
    if rc != 0 or fetched or [st["status"] for st in stages.values()] != ["SKIP", "SKIP"]:
        raise AssertionError(f"verify_real offline: rc {rc}, {stages}, {len(fetched)} fetch attempts")

    # the golden stage on the synthetic VCTK set (not VCTK: ok is False)
    vctk = ensure_synthetic_vctk(os.path.join(work, "vctk_test"), files_per_speaker=2)
    ok, grows = verify_real.run_golden(vctk, batch_size=4)
    log(f"[utilities] verify_real.run_golden on the synthetic VCTK set: ok {ok}, rows {json.dumps(grows)}")
    if ok or not all(math.isfinite(r["got"]) for r in grows):
        raise AssertionError(f"run_golden on the synthetic set: ok {ok}, rows {grows}")

    # examples.test: every family on ./datasets/vctk_test (the synthetic set)
    run_dir = os.path.join(work, "example_run")
    ensure_synthetic_vctk(os.path.join(run_dir, "datasets", "vctk_test"), files_per_speaker=2)
    cwd = os.getcwd()
    os.chdir(run_dir)
    try:
        before = stft_magnitude_kernel.launches
        t = time.perf_counter()
        res = example_test.test()
        ex_s = time.perf_counter() - t
    finally:
        os.chdir(cwd)
    keys = ["proc_fft_24000_44100", "proc_bw_24000_6_44100", "proc_subsampling_24000_44100", "proc_mp3_128_44100"]
    avg = res["averaged"]
    log(f"[utilities] examples.test on the synthetic set ({ex_s:.2f} s, |STFT| launches "
        f"{stft_magnitude_kernel.launches - before}, mp3 codec {mp3_codec()}): averaged {json.dumps(avg)}")
    if not all(k in avg and all(math.isfinite(avg[k][m]) for m in METRICS) for k in keys):
        raise AssertionError(f"examples.test: keys {sorted(avg)}")
    return launches


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def phase_parallel(work, flac, train_step_s):
    """The data-parallel path at world size 1 over NCCL: the multihost
    sweep on the FLAC data and one data-parallel generator step."""
    import glob

    import torch

    import ssr_eval_tpu_torch
    from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_backward_kernel, stft_magnitude_kernel
    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.harness.resume import process_journal_path
    from ssr_eval_tpu_torch.models.data import MelPairPipeline
    from ssr_eval_tpu_torch.models.train import NVSRTrainer, make_mesh
    from ssr_eval_tpu_torch.parallel import data_mesh
    from ssr_eval_tpu_torch.parallel.multihost import init_distributed

    port = _free_port()
    dev = init_distributed(f"localhost:{port}", 1, 0)
    try:
        log(f"[parallel] init_distributed: backend {torch.distributed.get_backend()}, world size "
            f"{torch.distributed.get_world_size()}, device {dev} (tcp://localhost:{port})")
        if torch.distributed.get_backend() != "nccl":
            raise AssertionError("the card's process group is not NCCL")
        testee, _ = noisy_testee(dev)
        kw = dict(flac["kw"], test_name="chip_parallel")
        helper = ssr_eval_tpu_torch.SSR_Eval_Helper(testee, mesh=data_mesh(), **kw)
        audios = [speechlike(2.0, SR, seed=s) for s in range(GEN_AUDIOS)]
        pipe = MelPairPipeline(crop_seconds=GEN_CROP, cutoffs=GEN_CUTOFFS)
        wav = pipe.random_crops(audios, np.random.default_rng(123), GEN_BATCH)
        plain = NVSRTrainer(model_name="unet", learning_rate=GEN_LR)
        mesh = make_mesh(tp=1)
        dp = NVSRTrainer(model_name="unet", learning_rate=GEN_LR, mesh=mesh)
        log(f"[parallel] make_mesh(tp=1): shape {mesh.shape}, sub-groups {sorted(mesh.groups)}; tensor "
            "parallelism (tp = 2) is held only by the CPU gloo tests (tests/test_torch_tensor_parallel.py): "
            "this machine has one H100, and NCCL cannot place two ranks on one card")

        stft_magnitude_kernel.launches = stft_magnitude_backward_kernel.launches = 0
        res = helper.evaluate(multihost=True, verbose=False)
        mel_lr, mel_hr = pipe.make_pair(wav, 1)
        torch.backends.cudnn.deterministic = True  # the same algorithms for both steps
        try:
            s_plain, loss_plain = plain.step(plain.init_state(seed=0), mel_lr, mel_hr)
            s_dp, loss_dp = dp.step(dp.init_state(seed=0), mel_lr, mel_hr)
        finally:
            torch.backends.cudnn.deterministic = False
        torch.cuda.synchronize()
        launches = stft_magnitude_kernel.launches
        bwd = stft_magnitude_backward_kernel.launches

        delta, finite = _stem_delta(res, flac["card"])
        jsons = glob.glob(os.path.join("results", "*-chip_parallel.json"))
        journal = process_journal_path(os.path.join("results", "chip_parallel.partial.jsonl"), 0, 1)
        log(f"[parallel] evaluate(multihost=True) with mesh=data_mesh(): max |parallel - flac| per pair "
            f"{json.dumps(delta)}; results JSON {len(jsons)}; journal {journal} "
            f"{'present' if os.path.exists(journal) else 'MISSING'}; decoders "
            f"{sorted(helper.engine.stats.decoders)}")
        if not finite or any(delta[k] > 1e-6 for k in METRICS) or len(jsons) != 1 or not os.path.exists(journal):
            raise AssertionError(f"the multihost sweep failed: {delta}, {len(jsons)} JSON, journal {journal}")
        d_loss = abs(float(loss_dp) - float(loss_plain)) / abs(float(loss_plain))
        g_plain, g_dp = _grads_of(s_plain["model"]), _grads_of(s_dp["model"])
        d_grad, leaf = _leaf_delta(g_plain, g_dp, 0.0)
        d_model, leaf_model = _leaf_delta(g_plain, g_dp, 1.0)
        log(f"[parallel] NVSRTrainer('unet', mesh=make_mesh(tp=1)) vs no mesh, one step from seed 0 on one batch "
            f"[{GEN_BATCH}, {mel_lr.shape[1]}, {mel_lr.shape[2]}] (cudnn deterministic): loss {float(loss_dp):.7f} "
            f"vs {float(loss_plain):.7f} (relative {d_loss:.3e}); gradients {d_grad:.3e} of the leaf's own max "
            f"({leaf}), {d_model:.3e} of the model's largest ({leaf_model}); |STFT| launches on the path {launches} "
            f"(8 per sweep batch + 2 for the mel pair), backward {bwd}")
        if not d_loss <= DP_TOL or not d_grad <= DP_TOL:
            raise AssertionError(f"data-parallel step off the plain step: loss {d_loss}, gradients {d_grad} ({leaf})")
        want = -(-N_UTTS // BATCH) * (1 + len(CUTOFFS)) + 2
        if launches != want or bwd:
            raise AssertionError(f"parallel path: {launches} |STFT| launches (expected {want}), {bwd} backward")
        del plain, s_plain
        _free_card()
        times = []
        for _ in range(GEN_FIXED_STEPS):
            t = time.perf_counter()
            _, loss = dp.step(s_dp, mel_lr, mel_hr)
            float(loss)  # synchronises
            times.append(time.perf_counter() - t)
        median = sorted(times)[len(times) // 2]
        log(f"[parallel] data-parallel generator s/step {[round(x, 4) for x in times]} (best {min(times):.4f}, "
            f"median {median:.4f}; the train phase's plain trainer: best {min(train_step_s):.4f}, median "
            f"{sorted(train_step_s)[len(train_step_s) // 2]:.4f})")
        busy = profile_call(lambda: [dp.step(s_dp, mel_lr, mel_hr) for _ in range(2)], "parallel-profile", keep="nccl")
        idle = None if busy is None else 1 - busy / 2e3 / median
        # what one BatchNorm's collective costs: 100 all-reduces of a
        # [2, 384] tensor (the widest BatchNorm's moments), synchronised
        x = torch.zeros(2, 384, device=dev)
        torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(100):
            torch.distributed.all_reduce(x)
        torch.cuda.synchronize()
        per_call = (time.perf_counter() - t) / 100
        n_bn = sum(1 for m in s_dp["model"].modules() if getattr(m, "sync_stats", False))
        log(f"[parallel] idle share against the unprofiled median DP step {idle}; one NCCL all_reduce of "
            f"[2, 384] {per_call * 1e6:.1f} us ({n_bn} synchronised BatchNorms: one forward and one backward "
            f"all-reduce each per step, {2 * n_bn * per_call:.4f} s/step at that rate)")
        del dp, s_dp
        _free_card()
    finally:
        torch.distributed.destroy_process_group()
    return launches


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA card: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import ssr_eval_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    card = card_line()
    log(f"[env] {card}; torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    phase_build()
    shapes = phase_kernel()
    with tempfile.TemporaryDirectory() as work:
        cwd = os.getcwd()
        os.chdir(work)  # the helper writes results/ into the working directory
        try:
            sweep = phase_sweep(work)
            flac = phase_flac(work, sweep)
            launches = {"sweep": sweep["launches"], "flac": flac["launches"]}
            launches["install"] = phase_install(work, flac)
            phase_smoke(work)
            phase_invariance(work)
            launches["matrix"] = phase_matrix(work)
            launches["families"] = phase_families(work)
            launches["leaderboard"] = phase_utilities(work, sweep, flac)
            launches["nvsr"], jax_trained_lsd = phase_nvsr(work)
            train_launches, bwd_shapes, gen_times = phase_train(work)
            launches.update(phase_train_small(work, jax_trained_lsd))
            launches["parallel"] = phase_parallel(work, flac, gen_times)
        finally:
            os.chdir(cwd)
    log(f"[env] all phases {time.perf_counter() - t0:.1f} s")
    launches["train_generator"] = train_launches["train_generator"]
    launches["train_vocoder"] = train_launches["train_vocoder"]
    head = shapes[0]
    kernel = {
        "name": "stft_magnitude",
        "route": "cuda",
        "source": "ssr_eval_tpu_torch/csrc/stft_magnitude.cu",
        "replaces": "ssr_eval_tpu/dsp/pallas_stft.py:123",
        "launches": launches["nvsr"],
        "launches_by_path": launches,
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "max_rel_err": max(s["max_rel_err"] for s in shapes),
        "max_rel_err_f64": max(s["max_rel_err_f64"] for s in shapes),
        "ms": head["ms"],
        "kernel_ms": head["ms"],
        "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "shapes": shapes,
    }
    bhead = bwd_shapes[0]  # the vocoder loss's shape
    backward = {
        "name": "stft_magnitude_backward",
        "route": "cuda",
        "source": "ssr_eval_tpu_torch/csrc/stft_magnitude.cu",
        "replaces": "ssr_eval_tpu/dsp/pallas_stft.py:123",
        "replaces_note": "the gradient of that kernel's function; the JAX package lets XLA differentiate its |STFT|",
        "launches": train_launches["train_vocoder_backward"],
        "max_abs_err": max(s["max_abs_err"] for s in bwd_shapes),
        "max_rel_err": max(s["max_rel_err"] for s in bwd_shapes),
        "max_rel_err_f64": max(s["max_rel_err_f64"] for s in bwd_shapes),
        "ms": bhead["ms"],
        "plain_ms": bhead["plain_ms"],
        "bound_ms": bhead["bound_ms"],
        "bound_by": bhead["bound_by"],
        "library_ms": bhead["library_ms"],
        "shapes": bwd_shapes,
    }
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel, backward]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--install-child"]:
        sys.exit(install_child(*sys.argv[2:]))
    sys.exit(main())
