"""Zero-phase IIR filtering (scipy `sosfiltfilt` semantics) on batched buffers.

The reference degrades audio with scipy's ``sosfiltfilt`` over
butter/cheby1/cheby2/ellip/bessel SOS designs (reference lowpass.py:94-131).
A per-sample recurrence is serial; the LTI identity

    sosfilt(sos, ext, zi=zi*ext[0]) == conv(ext, h) + ext[0] * r

turns each causal pass into one FFT convolution.  ``h`` is the cascade's
impulse response and ``r`` its zero-input response from the unit initial
state ``zi``; both are designed on the host in float64 once per filter, as
in ``ssr_eval_tpu.dsp.filters`` (the host design below is a copy of it).

scipy semantics replicated exactly:
  - odd edge extension of length ``edge = 3 * (2*n_sections + 1)``
  - forward pass with initial state ``sosfilt_zi(sos) * ext[0]``
  - reversed pass with initial state ``zi * y_fwd[-1]``
  - trim ``edge`` from both sides.

Application works on ``[B, Lmax]`` buffers with per-row true lengths
``[B]``; the reversed prefix and the right edge are per-row gathers, so
each row depends only on its own data.  Transforms are ``torch.fft`` in
float32 (no matmul: a CPU GEMM's rows change with the row count).
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple

import numpy as np
import torch
from scipy import signal as _sps


class FiltFiltPlan(NamedTuple):
    """Host-designed, device-applied zero-phase filter plan."""

    edge: int            # odd-extension length per side
    h: np.ndarray        # [n_ext_max] cascade impulse response (f32)
    r: np.ndarray        # [n_ext_max] zero-input response of unit zi (f32)
    fft_size: int        # convolution FFT size (power of 2)
    m: int               # truncated response length: sum|h[m:]| and
                         # sum|r[m:]| both < _TRUNC_TOL (blocked path)


def design_lowpass_sos(ftype: str, order: int, highcut: float, fs: float) -> np.ndarray:
    """SOS lowpass design, matching reference lowpass.py:112-123 parameters
    (cheby1 rp=0.1 dB, cheby2 rs=60 dB, ellip rp=0.1/rs=60)."""
    nyq = 0.5 * fs
    hi = highcut / nyq
    if ftype == "butter":
        return _sps.butter(order, hi, btype="low", output="sos")
    if ftype == "cheby1":
        return _sps.cheby1(order, 0.1, hi, btype="low", output="sos")
    if ftype == "cheby2":
        return _sps.cheby2(order, 60, hi, btype="low", output="sos")
    if ftype == "ellip":
        return _sps.ellip(order, 0.1, 60, hi, btype="low", output="sos")
    if ftype == "bessel":
        return _sps.bessel(order, hi, btype="low", output="sos")
    raise ValueError(f"The lowpass filter {ftype} is not supported!")


def design_bandpass_sos(ftype: str, order: int, lowcut: float, highcut: float, fs: float) -> np.ndarray:
    """SOS bandpass design (reference lowpass.py:72-84 parameters)."""
    nyq = 0.5 * fs
    band = [lowcut / nyq, highcut / nyq]
    if ftype == "butter":
        return _sps.butter(order, band, btype="band", output="sos")
    if ftype == "cheby1":
        return _sps.cheby1(order, 0.1, band, btype="band", output="sos")
    if ftype == "cheby2":
        return _sps.cheby2(order, 60, band, btype="band", output="sos")
    if ftype == "ellip":
        return _sps.ellip(order, 0.1, 60, band, btype="band", output="sos")
    if ftype == "bessel":
        return _sps.bessel(order, band, btype="band", output="sos")
    raise ValueError(f"The bandpass filter {ftype} is not supported!")


def _next_pow2(n: int) -> int:
    return 1 << (n - 1).bit_length()


# Truncation tolerance for the blocked (overlap-save) path: the residual
# convolution error is bounded by sum|h[m:]| * max|x|, so this bounds the
# relative output error directly (DC gain of every sweep lowpass is ~1).
_TRUNC_TOL = 1e-6


def _tail_len(v: np.ndarray, tol: float) -> int:
    """Smallest m with sum|v[m:]| < tol (0 if the whole tail is below)."""
    tails = np.cumsum(np.abs(v)[::-1])[::-1]
    if tails[0] < tol:
        return 0
    return int(np.argmax(tails < tol)) if tails[-1] < tol else v.shape[0]


@functools.lru_cache(maxsize=64)
def _plan_cache(sos_bytes: bytes, n_sections: int, max_len: int) -> FiltFiltPlan:
    sos = np.frombuffer(sos_bytes, dtype=np.float64).reshape(n_sections, 6).copy()
    ntaps = 2 * n_sections + 1
    ntaps -= min(int((sos[:, 2] == 0).sum()), int((sos[:, 5] == 0).sum()))
    edge = ntaps * 3
    n_ext = max_len + 2 * edge
    # Impulse response (zero-state) and unit-zi zero-input response, f64.
    impulse = np.zeros(n_ext)
    impulse[0] = 1.0
    h = _sps.sosfilt(sos, impulse)
    zi = _sps.sosfilt_zi(sos)
    r, _ = _sps.sosfilt(sos, np.zeros(n_ext), zi=zi)
    fft_size = _next_pow2(2 * n_ext)
    m = max(_tail_len(h, _TRUNC_TOL), _tail_len(r, _TRUNC_TOL), 1)
    return FiltFiltPlan(
        edge=edge,
        h=h.astype(np.float32),
        r=r.astype(np.float32),
        fft_size=fft_size,
        m=m,
    )


@functools.lru_cache(maxsize=256)
def _response_len_cache(sos_bytes: bytes, n_sections: int) -> int:
    """Truncated-response length for an SOS cascade, independent of the
    bucket length (stable poles: the response decays exponentially, so a
    2^18-sample probe covers every design the order clamp [2,10] allows)."""
    sos = np.frombuffer(sos_bytes, dtype=np.float64).reshape(n_sections, 6).copy()
    probe = 1 << 18
    impulse = np.zeros(probe)
    impulse[0] = 1.0
    h = _sps.sosfilt(sos, impulse)
    zi = _sps.sosfilt_zi(sos)
    r, _ = _sps.sosfilt(sos, np.zeros(probe), zi=zi)
    return max(_tail_len(h, _TRUNC_TOL), _tail_len(r, _TRUNC_TOL), 1)


def response_len(sos: np.ndarray) -> int:
    sos = np.ascontiguousarray(sos, dtype=np.float64)
    return _response_len_cache(sos.tobytes(), sos.shape[0])


def make_filtfilt_plan(sos: np.ndarray, max_len: int, edge_max: int | None = None) -> FiltFiltPlan:
    """Build (and cache) the plan for a given SOS and bucket length."""
    sos = np.ascontiguousarray(sos, dtype=np.float64)
    plan = _plan_cache(sos.tobytes(), sos.shape[0], max_len)
    if edge_max is not None and plan.edge > edge_max:
        raise ValueError(f"edge {plan.edge} exceeds edge_max {edge_max}")
    return plan


def blocked_plan_arrays(plan: FiltFiltPlan, block: int, truncate: bool = False):
    """Host arrays for the blocked path: ((Hr, Hi) over 2*block, r[:block]).

    With ``truncate=True`` a response slightly longer than the block is cut
    at ``block`` instead of raising: the block is sized from a 2^18-sample
    probe (`response_len`), so a longer bucket can nudge `plan.m` just past
    it.  The discarded tail mass is measured here, and a warning reports
    the true error bound when it reaches the tolerance."""
    if plan.m > block and not truncate:
        raise ValueError(f"truncated response {plan.m} exceeds block {block}")
    m = min(plan.m, block)
    if m < plan.m:
        tail_h = float(np.sum(np.abs(plan.h[m:].astype(np.float64))))
        tail_r = float(np.sum(np.abs(plan.r[m:].astype(np.float64))))
        if max(tail_h, tail_r) >= _TRUNC_TOL:
            warnings.warn(
                f"blocked filtfilt truncation at block={block} discards "
                f"tail mass sum|h[{m}:]|={tail_h:.3e}, "
                f"sum|r[{m}:]|={tail_r:.3e} >= {_TRUNC_TOL:.0e}; the "
                "relative output error is bounded by that mass (slowly-"
                "decaying high-order low-cutoff IIR on a long bucket) — "
                "use the monolithic sosfiltfilt path for this spec",
                RuntimeWarning,
                stacklevel=2,
            )
    h = np.zeros(2 * block, dtype=np.float64)
    h[:m] = plan.h[:m].astype(np.float64)
    H = np.fft.rfft(h)
    r = np.zeros(block, dtype=np.float32)
    r[:m] = plan.r[:m]
    return (
        (H.real.astype(np.float32), H.imag.astype(np.float32)),
        r,
    )


def plan_device_arrays(plan: FiltFiltPlan, device):
    """Device constants for a plan: (H = rfft(h) as complex64, r)."""
    h = np.zeros(plan.fft_size, dtype=np.float32)
    h[: plan.h.shape[0]] = plan.h
    H = np.fft.rfft(h)
    return (
        complex_from_parts(H.real.astype(np.float32), H.imag.astype(np.float32), device),
        torch.from_numpy(plan.r).to(device),
    )


def complex_from_parts(re: np.ndarray, im: np.ndarray, device) -> torch.Tensor:
    """float32 real/imag host arrays -> one complex64 tensor on `device`."""
    return torch.complex(torch.from_numpy(re), torch.from_numpy(im)).to(device)


# ----------------------------------------------------------------------
# Application on [B, Lmax] buffers
# ----------------------------------------------------------------------


def _flip_prefix(y: torch.Tensor, n_valid: torch.Tensor, out_size: int) -> torch.Tensor:
    """out[b, v] = y[b, n_valid[b] - 1 - v] for v < n_valid[b], else 0."""
    idx = n_valid[:, None] - 1 - torch.arange(out_size, device=y.device)[None, :]
    got = torch.gather(y, 1, idx.clamp(0, y.shape[1] - 1))
    return torch.where(idx >= 0, got, torch.zeros_like(got))


def _odd_extend(x: torch.Tensor, length: torch.Tensor, edge: int, edge_max: int) -> torch.Tensor:
    """scipy's odd_ext per row inside a [B, Lmax + 2*edge_max] buffer.

    ext = [2*x[0] - x[edge..1], x[0..L), 2*x[L-1] - x[L-2..L-edge-1], 0...]
    Contract: x is zero beyond `length` (bucket buffers are) and
    length > edge (utterances are orders of magnitude longer)."""
    B, Lmax = x.shape
    ext = x.new_zeros(B, Lmax + 2 * edge_max)
    if edge == 0:
        ext[:, :Lmax] = x
        return ext
    ext[:, :edge] = 2.0 * x[:, :1] - x[:, 1 : edge + 1].flip(-1)
    ext[:, edge : edge + Lmax] = x
    n = length.to(torch.int64)[:, None]
    j = torch.arange(edge, device=x.device)[None, :]
    xl = torch.gather(x, 1, (n - 1).clamp(min=0))
    right = 2.0 * xl - torch.gather(x, 1, (n - 2 - j).clamp(min=0))
    # x is zero from edge + L on, so the per-row write lands on zeros.
    return ext.scatter_(1, edge + n + j, right)


def _valid(n_buf: int, n_valid: torch.Tensor, device) -> torch.Tensor:
    return torch.arange(n_buf, device=device)[None, :] < n_valid[:, None]


def _fft_lfilter(ext, x0, H, r, fft_size: int):
    """One causal IIR pass: zero-state FFT convolution + scaled zi response.

    ext: [B, n] (zero beyond its valid prefix); H: rfft of the padded
    impulse response [fft_size//2+1] complex64; r: [n] unit-zi zero-input
    response, scaled per row by x0 [B]."""
    n = ext.shape[1]
    X = torch.fft.rfft(ext, n=fft_size, dim=-1)
    y = torch.fft.irfft(X * H, n=fft_size, dim=-1)[:, :n]
    return y + x0[:, None] * r[None, :n]


def _block_conv(ext, x0, H, r_trunc, block: int):
    """Overlap-save causal IIR pass: conv(ext, h) + x0 * r on [B, n].

    H: rfft of the m <= block truncated impulse response padded to
    2*block; r_trunc: [block].  The signal is cut into `block`-hop,
    2*block-long frames; each frame's second half is exact because the
    truncated kernel never wraps into it."""
    B, n = ext.shape
    nb = -(-n // block)
    padded = torch.nn.functional.pad(ext, (block, nb * block - n))
    frames = padded.unfold(-1, 2 * block, block)  # [B, nb, 2*block]
    Y = torch.fft.rfft(frames, n=2 * block, dim=-1) * H
    y = torch.fft.irfft(Y, n=2 * block, dim=-1)[..., block:].reshape(B, nb * block)[:, :n]
    m = min(r_trunc.shape[0], n)
    return torch.cat([y[:, :m] + x0[:, None] * r_trunc[None, :m], y[:, m:]], dim=1)


def _filtfilt(x, length, edge: int, edge_max: int, causal_pass):
    """The shared forward-backward structure around a causal pass
    `causal_pass(buf, x0) -> [B, n]`."""
    Lmax = x.shape[1]
    n_ext_buf = Lmax + 2 * edge_max
    n_ext = length.to(torch.int64) + 2 * edge
    valid = _valid(n_ext_buf, n_ext, x.device)

    ext = _odd_extend(x, length, edge, edge_max)
    y_f = torch.where(valid, causal_pass(ext, ext[:, 0]), 0.0)
    # Reverse the valid prefix (z[v] = y_f[n_ext-1-v]), filter again.
    z = _flip_prefix(y_f, n_ext, n_ext_buf)
    y_b = torch.where(valid, causal_pass(z, z[:, 0]), 0.0)
    # Undo the reversal and trim `edge` from both sides:
    # result[k] = y_b[n_ext - 1 - (edge + k)].
    out = _flip_prefix(y_b, n_ext, n_ext_buf)[:, edge : edge + Lmax]
    return torch.where(_valid(Lmax, length, x.device), out, 0.0)


def sosfiltfilt(x, length, plan: FiltFiltPlan, H, r):
    """Zero-phase filter buffered signals with one plan; -> [B, Lmax]
    (zero beyond each length).  H, r: `plan_device_arrays(plan, device)`."""
    return sosfiltfilt_dynamic(x, length, plan.edge, H, r, plan.fft_size, plan.edge)


def sosfiltfilt_dynamic(x, length, edge: int, H, r, fft_size: int, edge_max: int):
    """Zero-phase filter with the filter as data: (H, r) sized for
    `edge_max`, so one set of buffer shapes serves every (ftype, order,
    cutoff) of a sweep.

    x: [B, Lmax]; length: [B]; H: rfft of the padded impulse response
    [fft_size//2+1] complex64; r: [Lmax + 2*edge_max] zero-input response
    (zero-padded past its design length; those positions are masked)."""
    return _filtfilt(
        x, length, edge, edge_max, lambda buf, x0: _fft_lfilter(buf, x0, H, r, fft_size)
    )


def sosfiltfilt_blocked(x, length, edge: int, H, r_trunc, block: int, edge_max: int):
    """Zero-phase filter via overlap-save block convolution: the contract
    of `sosfiltfilt_dynamic`, with the two causal passes as batched
    2*block-point FFTs instead of one next_pow2(2*Lmax)-point transform.
    `H` is the rfft of the truncated impulse response padded to 2*block;
    `r_trunc` is [block].  Requires the truncated response length m <=
    block (guaranteed by the plan's block choice)."""
    return _filtfilt(
        x, length, edge, edge_max, lambda buf, x0: _block_conv(buf, x0, H, r_trunc, block)
    )
