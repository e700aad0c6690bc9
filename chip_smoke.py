#!/usr/bin/env python3
"""Drive ssr_eval_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py          # from the repository root; needs one card

Phases (any failure raises and the script exits non-zero):
  build      nvcc builds every kernel under ssr_eval_tpu_torch/csrc/ into
             ssr_eval_tpu_torch/_build/ (one nvcc per source, in parallel).
  kernel     the |STFT| kernel on the card at the main path's shapes
             (2048/441, 2229/480 and 743/160, 16 buffers -> [16, 744,
             n_bins]): max|kernel - plain| <= 1e-4 of max|plain| and
             max|kernel - float64 rfft| <= 2e-6 of its max (the plain
             version's float64 error printed beside it); kernel, plain and
             torch.stft (a yardstick the port never calls) timed with CUDA
             events; the bound computed from the shapes.
  sweep      the headline fft sweep through SSR_Eval_Helper.evaluate on the
             card: 16 speech-like 6 s utterances at 44.1 kHz, 7 cutoffs of
             1-16 kHz, batch 16, a broadband-noise testee.  The kernel's
             launch count must grow by 8 per batch (1 target + 7 estimates).
             Per-pair metrics must agree with the same sweep on the CPU and,
             for two utterances, with the float64 NumPy oracle.
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
             sosfiltfilt / resample_poly + tests/oracles.py): LSD <= 1e-3.
  families   the JAX package's multi-family golden run (identity host testee,
             synthetic VCTK, 2 files per speaker) on the card: SiSpec and SSIM
             inside the golden TOL, LSD and log-SiSpec (float32 stop-band
             floors) within FLOOR_TOL of the JAX package's CPU pins.

Output: per-phase lines, then the card's name and power limit, a
{"kernels": [...]} line, and last {"ok": true, "device": {...}}.
"""

from __future__ import annotations

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
# Card vs the CPU run of the same sweep, per (file, spec) pair: about 5x
# the first measured maxima on an H100 (LSD 5.0e-5, log-SiSpec 4.4e-4,
# SiSpec 7.6e-6 dB, SSIM 1.2e-7; PERF.md).
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


def noisy_testee(device):
    import torch

    from ssr_eval_tpu_torch.harness.testee import BatchedTestee, state_from_numpy

    class NoisyTestee(BatchedTestee):
        """Adds a fixed broadband floor: estimated spectra sit far above any
        float32 rounding floor, so metric deltas measure the pipeline."""

        def __init__(self, state):
            self.state = state

        def device_state(self):
            return self.state

        def infer_batch(self, x, lengths, state=None):
            ar = torch.arange(x.shape[1], device=x.device)
            mask = (ar[None, :] < lengths[:, None]).to(torch.float32)
            return x.to(torch.float32) + state[ar % state.shape[0]][None, :] * mask, lengths

    noise = (1e-3 * np.random.default_rng(NOISE_SEED).standard_normal(1 << 17)).astype(np.float32)
    return NoisyTestee(state_from_numpy(noise, device)), noise


# ----------------------------------------------------------------------
# Phases
# ----------------------------------------------------------------------


def phase_build():
    from ssr_eval_tpu_torch.dsp import _build

    t = time.perf_counter()
    paths = _build.build_all()
    log(f"[build] {len(paths)} kernel source(s) built in {time.perf_counter() - t:.2f} s")
    for p in paths.values():
        info = [ln.strip() for ln in p.with_suffix(".log").read_text().splitlines() if "Used" in ln or "spill" in ln]
        log(f"[build] {p.name}: {' | '.join(info)}")


def stft_bound(B, ext_len, mf, n_fft):
    """Least time for the |STFT| call on this card: bytes (ext read once,
    magnitudes written once) vs an FFT-class operation count
    (2.5 N log2 N per frame for a real transform, 3 per bin for |.|)."""
    n_bins = n_fft // 2 + 1
    nbytes = 4 * (B * ext_len + B * mf * n_bins + 3 * n_fft)
    flops = B * mf * (2.5 * n_fft * math.log2(n_fft) + 3 * n_bins)
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
    # (327,680) at 44.1 kHz evaluation, and that bucket resampled to the
    # 48 kHz (356,660) and 16 kHz (118,886) evaluation rates; all give 744
    # frames.
    for n_fft, hop, body in ((2048, 441, 327680), (2229, 480, 356660), (743, 160, 118886)):
        ext_len = body + 2 * (n_fft // 2)
        mf = 1 + (ext_len - n_fft) // hop
        ext = 0.1 * torch.randn(BATCH, ext_len, generator=g, device=dev)
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
        if not (got.shape == want.shape == (BATCH, mf, n_fft // 2 + 1)) or not rel <= 1e-4 or not rel64 <= 2e-6:
            raise AssertionError(
                f"stft kernel {n_fft}/{hop}: shape {tuple(got.shape)}, vs plain {rel:.3e} (limit 1e-4), "
                f"vs float64 {rel64:.3e} (limit 2e-6)"
            )
        ms = cuda_ms(lambda: stft_magnitude_kernel(ext, n_fft, hop, mf, win))
        plain_ms = cuda_ms(lambda: stft_magnitude_plain(ext, n_fft, hop, mf, win))
        library_ms = cuda_ms(
            lambda: torch.stft(ext, n_fft, hop, window=win, center=False, return_complex=True).abs()
        )
        bound_ms, bound_by, nbytes, flops = stft_bound(BATCH, ext_len, mf, n_fft)
        plan = _fft_plan(n_fft)
        s = dict(
            n_fft=n_fft, hop=hop, shape=[BATCH, mf, n_fft // 2 + 1], ext_len=ext_len,
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


def _oracle_one(path, noise):
    """The sweep for one utterance in float64 NumPy (tests/oracles.py)."""
    from tests.oracles import istft_np, lsd_np, sispec_np, ssim_np, stft_np

    from ssr_eval_tpu_torch.io.audio import decode_audio

    x = decode_audio(path)[0].astype(np.float64)
    tgt_sp = np.abs(stft_np(x, 2048, 441)).T
    Z0 = stft_np(x, 2048, 441)
    out = {}
    for c in CUTOFFS:
        Z = Z0.copy()
        Z[int(1025 * (c / int(SR / 2))) :, :] = 0.0
        est = istft_np(Z, 2048, 441, length=len(x))
        est = est + noise.astype(np.float64)[np.arange(len(est)) % noise.shape[0]]
        est_sp = np.abs(stft_np(est, 2048, 441)).T
        out[f"proc_fft_{2 * c}_{SR}"] = {
            "lsd": lsd_np(est_sp, tgt_sp),
            "log_sispec": sispec_np(np.log10(est_sp + 1e-12), np.log10(tgt_sp + 1e-12)),
            "sispec": sispec_np(est_sp, tgt_sp),
            "ssim": ssim_np(est_sp, tgt_sp),
        }
    return out


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

    times = []
    for _ in range(3):
        t = time.perf_counter()
        helper.evaluate(verbose=False)
        times.append(time.perf_counter() - t)
    best = min(times)
    log(
        f"[sweep] warm-up {warm_s:.3f} s; timed runs {[round(x, 4) for x in times]} s; "
        f"best {best / n_batches:.4f} s/batch, {N_UTTS / best:.2f} utt/s "
        f"({N_UTTS} utts x {len(CUTOFFS)} cutoffs, batch {BATCH}); kernel launches {launches}"
    )
    log("[sweep] stages over all card runs:", json.dumps(helper.engine.stats.summary()))
    profile_sweep(helper)

    cpu_testee, _ = noisy_testee(torch.device("cpu"))
    t = time.perf_counter()
    cpu = ssr_eval_tpu_torch.SSR_Eval_Helper(cpu_testee, device="cpu", **kw).evaluate(verbose=False)
    cpu_s = time.perf_counter() - t
    pc, pg = _pairs(cpu), _pairs(card)
    if set(pc) != set(pg) or len(pg) != N_UTTS * len(CUTOFFS):
        raise AssertionError("card and CPU sweeps scored different (file, spec) pairs")
    delta = {k: max(abs(pg[p][k] - pc[p][k]) for p in pg) for k in METRICS}
    finite = all(math.isfinite(pg[p][k]) for p in pg for k in METRICS)
    log(f"[sweep] CPU run {cpu_s:.2f} s; max |card - CPU| per pair: {json.dumps(delta)}")
    if not finite or any(delta[k] > CARD_VS_CPU[k] for k in METRICS):
        raise AssertionError(f"card vs CPU parity failed: {delta} (limits {CARD_VS_CPU}, finite={finite})")

    oracle = {k: 0.0 for k in METRICS}
    for i in range(2):
        f = f"utt_{i:03d}.wav"
        ref = _oracle_one(os.path.join(spk, f), noise)
        for key, m in ref.items():
            for k in METRICS:
                oracle[k] = max(oracle[k], abs(card["p000"][f][key][k] - m[k]))
    log(f"[sweep] max |card - float64 oracle| over 2 utterances x 7 cutoffs: {json.dumps(oracle)}")
    if oracle["lsd"] > 1e-3:
        raise AssertionError(f"card LSD off the float64 oracle by {oracle['lsd']:.3e} (limit 1e-3)")
    log("[sweep] averaged:", json.dumps(card["averaged"]))
    return launches


def profile_sweep(helper, tag="profile"):
    """One more warm sweep under torch.profiler: device busy time (the union
    of kernel and copy intervals), the wall time, the idle share, and the
    device time by kernel name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        helper.evaluate(verbose=False)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    spans = sorted(
        (e.time_range.start, e.time_range.end, e.name)
        for e in prof.events()
        if e.device_type == DeviceType.CUDA
    )
    if not spans:
        log(f"[{tag}] wall {wall_ms:.1f} ms; device time not measured (the profiler saw no CUDA events)")
        return
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
    # the top 12 by device time, and the |STFT| kernel wherever it ranks
    top = ranked[:12] + [kv for kv in ranked[12:] if "stft_fft_kernel" in kv[0]]
    log(f"[{tag}] wall {wall_ms:.1f} ms (under the profiler), device busy {busy:.1f} ms, "
        f"idle share {1 - busy / wall_ms:.3f}, {len(spans)} device events")
    for name, (ms, n) in top:
        log(f"[{tag}]   {ms:8.3f} ms  x{n:<4d} {name[:110]}")


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
    float64 (scipy designs and filters, tests/oracles.py metrics)."""
    from scipy import signal as sps

    from tests.oracles import lsd_np, sispec_np, ssim_np, stft_np

    from ssr_eval_tpu_torch.io.audio import decode_audio

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
    tests/oracles.py metrics), averaged per speaker and then over speakers
    like the helper."""
    from scipy import signal as sps

    from tests.oracles import lsd_np, sispec_np, ssim_np, stft_np

    from ssr_eval_tpu_torch.io.audio import decode_audio

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
            launches = {"sweep": phase_sweep(work)}
            phase_smoke(work)
            phase_invariance(work)
            launches["matrix"] = phase_matrix(work)
            launches["families"] = phase_families(work)
        finally:
            os.chdir(cwd)
    log(f"[env] all phases {time.perf_counter() - t0:.1f} s")
    head = shapes[0]
    kernel = {
        "name": "stft_magnitude",
        "route": "cuda",
        "source": "ssr_eval_tpu_torch/csrc/stft_magnitude.cu",
        "replaces": "ssr_eval_tpu/dsp/pallas_stft.py:123",
        "launches": launches["matrix"],
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
    print(card, flush=True)
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
