"""Per-family degradation on batched [B, Lmax] buffers.

Family semantics (reference quirks kept, as in ``ssr_eval_tpu.degrade.apply``):
- fft: STFT(2048/441), zero bins >= int(1025 * ratio) and the invalid
  frames, iSTFT to the original length (reference lowpass.py:17-28).  The
  reference's eps=1e-8 magnitude clamp cancels exactly in mag*cos /
  mag*sin, so the round trip is a plain mask on real/imag.
- iir: zero-phase SOS filtering; the host-designed impulse/zi responses and
  the odd-extension edge are per-spec data, so butter/cheby/ellip/bessel
  at any order share one degrader per (block, bucket).  Order is clamped to
  [2, 10] (lowpass.py:147-153,168) at design time.
- subsampling: resample_poly down then up with the reference's
  fs_ori=44100-always quirk (lowpass.py:134-144: `fs_ori` is never
  forwarded), then align_length to the input length.
- mp3 is host codec work (`degrade.codec`), not a device degradation.

The sweep engine runs a family's spec-independent work once per utterance
(`build_family_pre`, the fft family's forward STFT) and its spec-dependent
tail per spec (`build_family_apply`).  Family keys, and so the grouping of
specs, equal the JAX package's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ssr_eval_tpu_torch.degrade.plan import DegradationSpec
from ssr_eval_tpu_torch.device import device_cache
from ssr_eval_tpu_torch.dsp.filters import (
    blocked_plan_arrays,
    complex_from_parts,
    design_lowpass_sos,
    make_filtfilt_plan,
    response_len,
    sosfiltfilt_blocked,
    sosfiltfilt_dynamic,
)
from ssr_eval_tpu_torch.dsp.resample import apply_resample, resample_poly_plan
from ssr_eval_tpu_torch.dsp.spectral import (
    StftConfig,
    istft,
    n_frames_for_length,
    stft_real_imag,
)

# The degradation STFT (FDomainHelper defaults, reference dsp.py:7-10).
DEGRADE_STFT = StftConfig(n_fft=2048, hop=441)

# Upper bound on scipy's odd-extension edge: order<=10 lowpass -> <=5 SOS
# sections -> ntaps 11 -> edge 33; bandpass doubles sections -> 63.
EDGE_MAX = 64

# The subsampling family's source rate, whatever the input rate (the
# reference's fs_ori default, never overridden).
FS_ORI = 44100


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


def iir_fft_size(max_len: int) -> int:
    return _next_pow2(2 * (max_len + 2 * EDGE_MAX))


# Overlap-save block-size floor, and the cap beyond which a response is
# filtered with one full-buffer FFT instead (the JAX package's values, kept
# so that family keys match).
IIR_BLOCK_MIN = 1024
IIR_BLOCK_CAP = 1 << 15


def iir_block_size(spec: DegradationSpec) -> int | None:
    """Power-of-2 overlap-save block for `spec`, or None -> monolithic FFT.

    The truncated impulse-response length is a property of the filter
    alone (host-designed once, cached), so specs whose responses fit the
    same block share one degrader."""
    sos = design_lowpass_sos(spec.ftype, spec.clamped_order, spec.highcut, spec.sr)
    m = response_len(sos)
    if m > IIR_BLOCK_CAP:
        return None
    return max(_next_pow2(m), IIR_BLOCK_MIN)


def family_key(spec: DegradationSpec) -> tuple:
    """Specs with the same key share one pre/apply pair."""
    if spec.family == "fft":
        return ("fft",)
    if spec.family == "iir":
        return ("iir", iir_block_size(spec))
    if spec.family == "subsampling":
        return ("subsampling", spec.cutoff, spec.sr)  # ratio-dependent shapes
    if spec.family == "mp3":
        return ("mp3",)
    raise ValueError(f"unknown degradation family {spec.family!r}")


def subsampling_rate(cutoff: int, sr: int) -> int:
    """The intermediate rate of the subsampling family (fs_ori quirk)."""
    return int((cutoff // 2) / int(sr / 2) * FS_ORI)


def iir_host_arrays(spec: DegradationSpec, max_len: int, block: int | None) -> dict:
    """Host arrays of an iir spec: edge (int), Hr/Hi (float32 rfft of the
    impulse response) and r (float32 zero-input response), sized by the
    overlap-save `block` or, for block None (the monolithic path), by the
    bucket."""
    sos = design_lowpass_sos(spec.ftype, spec.clamped_order, spec.highcut, spec.sr)
    plan = make_filtfilt_plan(sos, max_len, edge_max=EDGE_MAX)
    if block is not None:
        # truncate=True: the block comes from a probe-length response
        # measurement, so a long bucket may push plan.m marginally past it;
        # blocked_plan_arrays warns when the cut tail is not negligible.
        (Hr, Hi), r = blocked_plan_arrays(plan, block, truncate=True)
        return {"edge": plan.edge, "Hr": Hr, "Hi": Hi, "r": r}
    h = np.zeros(iir_fft_size(max_len), dtype=np.float32)
    h[: plan.h.shape[0]] = plan.h
    H = np.fft.rfft(h)
    r = np.zeros(max_len + 2 * EDGE_MAX, dtype=np.float32)
    r[: plan.r.shape[0]] = plan.r
    return {
        "edge": plan.edge,
        "Hr": H.real.astype(np.float32),
        "Hi": H.imag.astype(np.float32),
        "r": r,
    }


@device_cache(maxsize=256)
def spec_params(spec: DegradationSpec, max_len: int, device: torch.device) -> dict:
    """Per-spec parameters on `device`: host design work happens once per
    (spec, bucket) and the arrays are uploaded once and cached."""
    if spec.family == "fft":
        return {"cut": int(DEGRADE_STFT.n_bins * spec.lowpass_ratio)}  # lowpass.py:24
    if spec.family == "iir":
        a = iir_host_arrays(spec, max_len, iir_block_size(spec))
        return {
            "edge": a["edge"],
            "H": complex_from_parts(a["Hr"], a["Hi"], device),
            "r": torch.from_numpy(a["r"]).to(device),
        }
    if spec.family == "subsampling":
        return {}
    raise ValueError(f"family {spec.family!r} is not a device degradation")


@device_cache(maxsize=64)
def _resample_weights(sr_in: int, sr_out: int, max_len: int, device: torch.device):
    """-> (ResamplePlan, its Wd on `device`), cached."""
    plan = resample_poly_plan(sr_in, sr_out, max_len)
    return plan, torch.from_numpy(plan.Wd).to(device)


@functools.lru_cache(maxsize=64)
def build_family_pre(key: tuple, max_len: int):
    """Spec-independent work of a family: fn(x [B,L], length [B]) -> ctx
    (None for families without any)."""
    if key[0] != "fft":
        return lambda x, length: None
    cfg = DEGRADE_STFT
    mf = cfg.max_frames(max_len)

    def pre(x, length):
        real, imag = stft_real_imag(x, length, cfg, mf)
        return {"real": real, "imag": imag}

    return pre


@functools.lru_cache(maxsize=64)
def build_family_apply(key: tuple, max_len: int):
    """Spec-dependent tail: fn(ctx, x, length, params) -> y [B, Lmax]."""
    family = key[0]
    if family == "fft":
        cfg = DEGRADE_STFT
        mf = cfg.max_frames(max_len)

        def fft_apply(ctx, x, length, params):
            nf = n_frames_for_length(cfg, length)
            fmask = torch.arange(mf, device=x.device)[None, :, None] < nf[:, None, None]
            bmask = torch.arange(cfg.n_bins, device=x.device)[None, None, :] < params["cut"]
            m = (fmask & bmask).to(ctx["real"].dtype)
            return istft(ctx["real"] * m, ctx["imag"] * m, length, cfg, max_len)

        return fft_apply

    if family == "iir":
        block = key[1]
        if block is not None:

            def iir_blocked_apply(ctx, x, length, params):
                return sosfiltfilt_blocked(
                    x, length, params["edge"], params["H"], params["r"], block, EDGE_MAX
                )

            return iir_blocked_apply
        fft_size = iir_fft_size(max_len)

        def iir_apply(ctx, x, length, params):
            return sosfiltfilt_dynamic(
                x, length, params["edge"], params["H"], params["r"], fft_size, EDGE_MAX
            )

        return iir_apply

    if family == "subsampling":
        _, cutoff, sr = key
        fs_down = subsampling_rate(cutoff, sr)
        o1 = int(resample_poly_plan(FS_ORI, fs_down, max_len).out_length(max_len))
        o2 = int(resample_poly_plan(fs_down, FS_ORI, o1).out_length(o1))

        def sub_apply(ctx, x, length, params):
            p1, W1 = _resample_weights(FS_ORI, fs_down, max_len, x.device)
            p2, W2 = _resample_weights(fs_down, FS_ORI, o1, x.device)
            y1, n1 = apply_resample(x, length, p1, o1, W1)
            y2, n2 = apply_resample(y1, n1, p2, o2, W2)
            # align_length (lowpass.py:142-143): zero-pad or crop to L.
            out = y2[:, :max_len] if o2 >= max_len else torch.nn.functional.pad(y2, (0, max_len - o2))
            idx = torch.arange(max_len, device=x.device)[None, :]
            return torch.where((idx < length[:, None]) & (idx < n2[:, None]), out, 0.0)

        return sub_apply

    raise ValueError(f"family {family!r} is not a device degradation")


def build_family_degrader(key: tuple, max_len: int):
    """-> fn(x [B, Lmax], length [B], params) -> y [B, Lmax]."""
    pre = build_family_pre(key, max_len)
    apply = build_family_apply(key, max_len)

    def degrade(x, length, params):
        return apply(pre(x, length), x, length, params)

    return degrade


def build_degrader(spec: DegradationSpec, max_len: int):
    """Single-spec degrader (the JAX package's back-compat builder):
    run(x [B, Lmax], length [B]) -> y [B, Lmax].  The spec's parameters
    are built for x's device on the first call and cached (`spec_params`)."""
    fn = build_family_degrader(family_key(spec), max_len)

    def run(x, length):
        return fn(x, length, spec_params(spec, max_len, x.device))

    return run
