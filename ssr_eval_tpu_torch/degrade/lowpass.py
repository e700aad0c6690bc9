"""User-facing degradation functions with reference-`lowpass.py` API parity.

`lowpass(data, highcut, fs, order, _type)` and `bandpass(...)` take 1-D
numpy arrays, dispatch with the reference's substring semantics
(`_type in "butter"` — lowpass.py:175-194), clamp the order to [2, 10] and
return numpy.  They are conveniences over the batched degraders (a batch
of one); the harness engine uses those directly.  Each runs on `device`
(keyword-only: None is the card, "cpu" the CPU).

The reference's latent no-op at lowpass.py:130 (a `subsampling()` call
whose result is discarded) is left out, as in the JAX package
(PARITY.md).
"""

from __future__ import annotations

import numpy as np
import torch

from ssr_eval_tpu_torch.degrade.apply import (
    DEGRADE_STFT,
    build_family_degrader,
    family_key,
    spec_params,
)
from ssr_eval_tpu_torch.degrade.plan import DegradationSpec
from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.dsp.filters import (
    design_bandpass_sos,
    design_lowpass_sos,
    make_filtfilt_plan,
    plan_device_arrays,
    sosfiltfilt,
)
from ssr_eval_tpu_torch.utils.bucket import pow2_bucket

_FILTERS = ("butter", "cheby1", "cheby2", "ellip", "bessel")


def limit(integer, high, low):
    """Order clamp (reference lowpass.py:147-153)."""
    if integer > high:
        return high
    if integer < low:
        return low
    return int(integer)


def align_length(x, y):
    """Pad/crop `y` to the length of `x` (reference lowpass.py:31-51)."""
    Lx, Ly = len(x), len(y)
    if Lx == Ly:
        return y
    if Lx > Ly:
        return np.pad(y, (0, Lx - Ly), mode="constant")
    return y[:Lx]


def _batch_of_one(data: np.ndarray, device):
    """1-D numpy -> ([1, bucket] tensor on `device`, length [1], bucket)."""
    L = data.shape[0]
    lmax = pow2_bucket(L)
    buf = np.zeros((1, lmax), dtype=np.float32)
    buf[0, :L] = data
    return torch.from_numpy(buf).to(device), torch.tensor([L], device=device), lmax


def _run_spec(spec: DegradationSpec, data: np.ndarray, device) -> np.ndarray:
    dev = resolve_device(device)
    x, n, lmax = _batch_of_one(data, dev)
    fn = build_family_degrader(family_key(spec), lmax)
    return fn(x, n, spec_params(spec, lmax, dev))[0, : data.shape[0]].cpu().numpy()


def _run_sos(sos: np.ndarray, data: np.ndarray, device) -> np.ndarray:
    dev = resolve_device(device)
    x, n, lmax = _batch_of_one(data, dev)
    plan = make_filtfilt_plan(sos, lmax)
    H, r = plan_device_arrays(plan, dev)
    return sosfiltfilt(x, n, plan, H, r)[0, : data.shape[0]].cpu().numpy()


def _check_1d(data):
    if data.ndim != 1:
        raise ValueError(
            "Error (chebyshev_lowpass_filter): Data "
            + str(data.shape)
            + " should be type 1d time array, (samples,) , can not be (samples, 1)"
        )


def lowpass(data, highcut, fs, order=5, _type="butter", *, device=None):
    """Reference-compatible lowpass entry (lowpass.py:156-196)."""
    data = np.asarray(data, dtype=np.float32)
    _check_1d(data)
    order = limit(order, high=10, low=2)

    def spec(family, ftype=None):
        return DegradationSpec(
            key="_direct", family=family, ftype=ftype, cutoff=int(highcut) * 2, order=order, sr=fs
        )

    # Branch set and order exactly as reference lowpass.py:175-194 (no
    # cheby2 branch there either — it is reachable only via bandpass/design).
    if _type in "butter":
        return _run_spec(spec("iir", "butter"), data, device)
    elif _type in "cheby1":
        return _run_spec(spec("iir", "cheby1"), data, device)
    elif _type in "ellip":
        return _run_spec(spec("iir", "ellip"), data, device)
    elif _type in "bessel":
        return _run_spec(spec("iir", "bessel"), data, device)
    elif _type in "subsampling":
        return _run_spec(spec("subsampling"), data, device)
    elif _type in "stft_hard":
        return _run_spec(spec("fft"), data, device)
    else:
        raise ValueError("Error: Unexpected filter type " + _type)


def lowpass_filter(x, highcut, fs, order, ftype, *, device=None):
    """Exact-type zero-phase lowpass (reference lowpass.py:94-131; unlike
    `lowpass`, cheby2 is reachable here and the order is NOT clamped)."""
    x = np.asarray(x, dtype=np.float32)
    if ftype not in _FILTERS:
        raise ValueError(f"The lowpass filter {ftype} is not supported!")
    sos = design_lowpass_sos(ftype, int(order), float(highcut), float(fs))
    return _run_sos(sos, x, device)


def bandpass_filter(x, lowcut, highcut, fs, order, ftype, *, device=None):
    """Exact-type zero-phase bandpass (reference lowpass.py:199-256
    inner function; no order clamp)."""
    x = np.asarray(x, dtype=np.float32)
    if ftype not in _FILTERS:
        raise ValueError(f"The bandpass filter {ftype} is not supported!")
    sos = design_bandpass_sos(ftype, int(order), int(lowcut), int(highcut), fs)
    return _run_sos(sos, x, device)


def bandpass(data, lowcut, highcut, fs, order=5, _type="butter", *, device=None):
    """Reference-compatible bandpass entry (lowpass.py:199-256)."""
    data = np.asarray(data, dtype=np.float32)
    _check_1d(data)
    for name in _FILTERS:
        if _type in name:
            order = limit(order, high=10, low=2)
            sos = design_bandpass_sos(name, order, int(lowcut), int(highcut), fs)
            return _run_sos(sos, data, device)
    raise ValueError("Error: Unexpected filter type " + _type)


def stft_hard_lowpass_v0(data, lowpass_ratio, *, device=None):
    """FFT-mask lowpass at a bin ratio (reference lowpass.py:17-28):
    STFT(2048/441), zero bins >= int(n_bins * ratio), length-exact iSTFT."""
    data = np.asarray(data, dtype=np.float32)
    _check_1d(data)
    dev = resolve_device(device)
    x, n, lmax = _batch_of_one(data, dev)
    fn = build_family_degrader(("fft",), lmax)
    y = fn(x, n, {"cut": int(DEGRADE_STFT.n_bins * lowpass_ratio)})
    return y[0, : data.shape[0]].cpu().numpy()


def subsampling(data, lowpass_ratio, fs_ori=44100):
    """resample_poly down-then-up on the host (reference lowpass.py:134-144)."""
    from scipy.signal import resample_poly

    data = np.asarray(data)
    fs_down = int(lowpass_ratio * fs_ori)
    y = resample_poly(data, fs_down, fs_ori)
    y = resample_poly(y, fs_ori, fs_down)
    return align_length(data, y)


def test1(*, device=None):
    """Self-test writing audible wavs for each degradation type
    (reference lowpass.py:259-277).  librosa's bundled trumpet clip is
    unreachable offline; a deterministic synthetic harmonic clip stands
    in with the same rates and parameters."""
    from ssr_eval_tpu_torch.harness.fixtures import speechlike
    from ssr_eval_tpu_torch.io.audio import write_wav

    data = speechlike(2.0, 44100, seed=0)
    cutoff, fs, order = 7000, 44100, 12

    print(data.shape)

    data_butter = lowpass(data, cutoff, fs, order, _type="butter", device=device)
    data_chebyshev = lowpass(data, cutoff, fs, order, _type="cheby1", device=device)
    data_stft = lowpass(data, cutoff, fs, order, _type="stft_hard", device=device)
    data_resample = lowpass(data, cutoff, fs, order, _type="subsampling", device=device)

    write_wav("original.wav", data, 44100)
    write_wav("butter.wav", data_butter, 44100)
    write_wav("cheby1.wav", data_chebyshev, 44100)
    write_wav("stft_hard.wav", data_stft, 44100)
    write_wav("subsampling.wav", data_resample, 44100)
