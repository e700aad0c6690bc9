"""|STFT| of hop-strided frames: the hand-written CUDA kernels (forward and
backward), their plain PyTorch versions, the kernels' table plan and the
launch counts.

Counterpart of ``ssr_eval_tpu/dsp/pallas_stft.py::fused_ct_stft_magnitude``
(the Pallas kernel ``_ct_kernel``).  The kernel (``csrc/stft_magnitude.cu``)
reads frames straight from the reflect-extended buffer at stride `hop`,
applies the window, transforms by a shared-memory FFT and takes the
magnitude in one pass, and writes only ``[B, max_frames, n_fft/2 + 1]``
float32.  It takes any n_fft <= 4096 by one of two paths: a power of two
through a half-length complex FFT and a split, every other size (the 48 kHz
2229/480 and 16 kHz 743/160 metric STFTs among them) by Bluestein's
chirp-z convolution.  `_fft_plan` builds each path's tables.

`stft_magnitude_kernel` launches the kernel for a CUDA tensor and takes
the plain version for a CPU tensor; it never falls back from the card.
A CUDA `ext` that requires a gradient goes through `StftMagnitudeFn`,
whose backward is the backward kernel of the same source, for every
n_fft <= 4096 in one launch: each block recomputes the spectra of the
frames over a segment of output samples (the forward's transform, then
its inverse), overlap-adds them in shared memory in ascending frame order
and writes the segment once (the frames that start before the segment
are recomputed by both blocks they touch).  Nothing but the output
reaches device memory and a row's gradient does not depend on its batch
or on the segment size.  Its bound is ext and grad_mag read once and the
gradient written once.  The JAX package has no such kernel: XLA
differentiates its |STFT|.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch
from torch.autograd.function import once_differentiable

from ssr_eval_tpu_torch.utils.flops import analytic_cost, stft_magnitude_backward_cost, stft_magnitude_cost

MAX_N_FFT = 4096


def stft_magnitude_plain(
    ext: torch.Tensor, n_fft: int, hop: int, max_frames: int, window: torch.Tensor
) -> torch.Tensor:
    """unfold x window -> torch.fft.rfft -> abs: [..., max_frames, n_fft//2+1]."""
    fr = ext.unfold(-1, n_fft, hop)[..., :max_frames, :]
    return torch.fft.rfft(fr * window, n=n_fft, dim=-1).abs()


class FftPlan(NamedTuple):
    """The kernel's transform for one n_fft: `kind` is "split" (a power of
    two >= 2: an n_fft/2-point complex FFT, then the real split) or
    "bluestein" (every other n_fft: two `fft_len`-point FFTs around the chirp
    convolution).  Tables are float32 [n, 2] (re, im), built in float64:
    twiddle: the per-pass Stockham twiddles of the fft_len-point FFT
    (`stockham_radices`), [pass][r - 1][k] = e^{-2 pi i r k / (Ns R)};
    table_a: split e^{-2 pi i k / n_fft} for k <= n_fft/2, or the chirp
    c[n] = e^{-i pi (n^2 mod 2 n_fft) / n_fft} for n < n_fft;
    table_b: Bluestein only, conj(FFT(b)) / fft_len for the wrapped
    b[m] = conj(c[|m|]), m in (-n_fft, n_fft/2]; the backward's inverse
    chirp-z multiplies by it too (its kernel's FFT is conj FFT(b))."""

    kind: str
    fft_len: int
    twiddle: np.ndarray
    table_a: np.ndarray
    table_b: np.ndarray | None


def stockham_radices(fft_len: int) -> list[int]:
    """Radices of the kernel's passes over a power-of-two length: radix 16,
    then one radix-2, 4 or 8 pass for the rest of log2."""
    p = fft_len.bit_length() - 1
    return [16] * (p // 4) + ([1 << (p % 4)] if p % 4 else [])


def _as_f32(z: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(np.stack([z.real, z.imag], axis=-1).astype(np.float32))


def _stockham_twiddles(fft_len: int) -> np.ndarray:
    rows, ns = [], 1
    for radix in stockham_radices(fft_len):
        m = (np.arange(1, radix)[:, None] * np.arange(ns)[None, :]) % (ns * radix)
        rows.append(np.exp(-2j * np.pi * m.ravel() / (ns * radix)))
        ns *= radix
    # fft_len = 1 has no pass; one unused entry keeps the table non-empty.
    return _as_f32(np.concatenate(rows) if rows else np.ones(1))


@functools.lru_cache(maxsize=32)
def _fft_plan(n_fft: int) -> FftPlan:
    """The kernel's transform and tables for 1 <= `n_fft` <= MAX_N_FFT (see
    FftPlan)."""
    if n_fft >= 2 and (n_fft & (n_fft - 1)) == 0:
        half = n_fft // 2
        split = np.exp(-2j * np.pi * np.arange(half + 1) / n_fft)
        return FftPlan("split", half, _stockham_twiddles(half), _as_f32(split), None)
    # Bins k < K = n_fft//2 + 1 of the circular convolution are exact once
    # M >= n_fft + K - 1.
    m_len = 1 << (n_fft + n_fft // 2 - 1).bit_length()
    n = np.arange(n_fft, dtype=np.int64)
    chirp = np.exp(-1j * np.pi * ((n * n) % (2 * n_fft)) / n_fft)
    b = np.zeros(m_len, np.complex128)
    b[: n_fft // 2 + 1] = np.conj(chirp[: n_fft // 2 + 1])
    if n_fft > 1:
        b[m_len - n_fft + 1 :] = np.conj(chirp[1:][::-1])
    d = np.conj(np.fft.fft(b)) / m_len
    return FftPlan("bluestein", m_len, _stockham_twiddles(m_len), _as_f32(chirp), _as_f32(d))


@functools.lru_cache(maxsize=16)
def _tables(n_fft: int, device: torch.device) -> tuple[int, torch.Tensor, torch.Tensor, torch.Tensor | None]:
    """(fft_len, twiddle, table_a, table_b) of `_fft_plan(n_fft)` on `device`."""
    plan = _fft_plan(n_fft)
    tabs = (plan.twiddle, plan.table_a, plan.table_b)
    return (plan.fft_len, *(None if a is None else torch.from_numpy(a).to(device) for a in tabs))


@functools.lru_cache(maxsize=1)
def _launcher():
    """The kernel's C entry point (builds csrc/ on first use)."""
    from ssr_eval_tpu_torch.dsp import _build

    fn = _build.library("stft_magnitude").ssr_stft_magnitude
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check(ext, n_fft, hop, max_frames, window):
    if ext.dtype != torch.float32 or window.dtype != torch.float32:
        raise TypeError(f"stft_magnitude_kernel takes float32, got {ext.dtype}/{window.dtype}")
    if not ext.is_contiguous() or not window.is_contiguous():
        raise ValueError("stft_magnitude_kernel takes contiguous tensors")
    if ext.dim() not in (1, 2):
        raise ValueError(f"ext must be [L] or [B, L], got shape {tuple(ext.shape)}")
    if not 1 <= n_fft <= MAX_N_FFT:
        raise ValueError(f"n_fft must be in [1, {MAX_N_FFT}], got {n_fft}")
    if hop < 1 or max_frames < 1:
        raise ValueError(f"hop and max_frames must be >= 1, got {hop}, {max_frames}")
    if tuple(window.shape) != (n_fft,):
        raise ValueError(f"window must have shape ({n_fft},), got {tuple(window.shape)}")
    need = (max_frames - 1) * hop + n_fft
    if ext.shape[-1] < need:
        raise ValueError(
            f"ext holds {ext.shape[-1]} samples; {max_frames} frames of {n_fft} "
            f"at hop {hop} need {need}"
        )
    if window.device != ext.device:
        raise ValueError(f"window on {window.device}, ext on {ext.device}")


def stft_magnitude_kernel(
    ext: torch.Tensor, n_fft: int, hop: int, max_frames: int, window: torch.Tensor
) -> torch.Tensor:
    """|rFFT(window * frame)| of frames ext[..., f*hop : f*hop + n_fft].

    ext: [L] or [B, L] float32, contiguous; window: [n_fft] float32 on the
    same device.  Returns [..., max_frames, n_fft//2 + 1] float32.  On a
    CUDA tensor it launches the kernel on the current stream without
    synchronising, through `StftMagnitudeFn` when grad is enabled and ext
    requires it; on a CPU tensor it computes the plain version, which
    autograd differentiates.
    """
    _check(ext, n_fft, hop, max_frames, window)
    if ext.device.type == "cuda" and torch.is_grad_enabled() and ext.requires_grad:
        return StftMagnitudeFn.apply(ext, n_fft, hop, max_frames, window)
    return _forward(ext, n_fft, hop, max_frames, window)


def _forward(ext, n_fft, hop, max_frames, window):
    """The forward with no graph: the kernel on a CUDA tensor, the plain
    version on a CPU tensor (arguments checked by the caller).  Inside a
    `utils.flops.count_cost` run either reports the same analytic cost."""
    if ext.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stft_magnitude_kernel runs on cuda or cpu, not {ext.device}")
    rows = ext.reshape(-1, ext.shape[-1])
    with analytic_cost(*stft_magnitude_cost(rows.shape[0], rows.shape[1], max_frames, n_fft)):
        if ext.device.type == "cpu":
            return stft_magnitude_plain(ext, n_fft, hop, max_frames, window)
        fn = _launcher()
        n_bins = n_fft // 2 + 1
        out = torch.empty(rows.shape[0], max_frames, n_bins, device=ext.device, dtype=torch.float32)
        fft_len, tw, tab_a, tab_b = _tables(n_fft, ext.device)
        with torch.cuda.device(ext.device):
            stream = torch.cuda.current_stream(ext.device).cuda_stream
            rc = fn(
                rows.data_ptr(), window.data_ptr(), tw.data_ptr(), tab_a.data_ptr(),
                None if tab_b is None else tab_b.data_ptr(), out.data_ptr(),
                rows.shape[0], rows.shape[1], n_fft, hop, max_frames, fft_len, stream,
            )
    if rc != 0:
        raise RuntimeError(f"stft_magnitude kernel launch failed: CUDA error {rc}")
    stft_magnitude_kernel.launches += 1
    return out.reshape(*ext.shape[:-1], max_frames, n_bins)


stft_magnitude_kernel.launches = 0


def stft_magnitude_backward_plain(
    ext: torch.Tensor, grad_mag: torch.Tensor, n_fft: int, hop: int, max_frames: int, window: torch.Tensor
) -> torch.Tensor:
    """d sum(grad_mag * |STFT|(ext)) / d ext by torch autograd through
    `stft_magnitude_plain`: [..., L], ext's shape."""
    with torch.enable_grad():
        e = ext.detach().requires_grad_(True)
        mag = stft_magnitude_plain(e, n_fft, hop, max_frames, window)
        (grad,) = torch.autograd.grad(mag, e, grad_mag)
    return grad


@functools.lru_cache(maxsize=1)
def _backward_launcher():
    """The backward's C entry point (builds csrc/ on first use)."""
    from ssr_eval_tpu_torch.dsp import _build

    fn = _build.library("stft_magnitude").ssr_stft_magnitude_backward
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _backward_plan(batch: int, ext_len: int, n_fft: int, hop: int, max_frames: int) -> int:
    """S, the frames per segment that the backward kernel takes for this
    shape on the current CUDA device (chip_smoke.py reports it)."""
    from ssr_eval_tpu_torch.dsp import _build

    fn = _build.library("stft_magnitude").ssr_stft_magnitude_backward_plan
    fn.argtypes = [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    s = ctypes.c_int(0)
    rc = fn(batch, ext_len, n_fft, hop, max_frames, _fft_plan(n_fft).fft_len, ctypes.byref(s))
    if rc != 0:
        raise RuntimeError(f"stft_magnitude backward plan failed: CUDA error {rc}")
    return s.value


def stft_magnitude_backward_kernel(
    ext: torch.Tensor, grad_mag: torch.Tensor, n_fft: int, hop: int, max_frames: int, window: torch.Tensor
) -> torch.Tensor:
    """The gradient of sum(grad_mag * |STFT|(ext)) with respect to ext.

    ext and window as for `stft_magnitude_kernel`; grad_mag [..., max_frames,
    n_fft//2 + 1] float32.  Returns ext's shape.  On a CUDA tensor it
    launches the backward kernel once, for any n_fft <= 4096; on a CPU
    tensor it computes the plain version.
    """
    return _backward(ext, grad_mag, n_fft, hop, max_frames, window, 0)


def _backward(ext, grad_mag, n_fft, hop, max_frames, window, seg_frames):
    """`stft_magnitude_backward_kernel` with the frames per segment S of a
    block forced (0: the kernel's own choice).  The result is the same for
    every S; the card tests and chip_smoke.py force S to check that."""
    _check(ext, n_fft, hop, max_frames, window)
    n_bins = n_fft // 2 + 1
    want = (*ext.shape[:-1], max_frames, n_bins)
    if tuple(grad_mag.shape) != want or grad_mag.dtype != torch.float32 or grad_mag.device != ext.device:
        raise ValueError(
            f"grad_mag must be float32 {want} on {ext.device}, got {grad_mag.dtype} "
            f"{tuple(grad_mag.shape)} on {grad_mag.device}"
        )
    if ext.device.type == "cpu":
        return stft_magnitude_backward_plain(ext, grad_mag, n_fft, hop, max_frames, window)
    if ext.device.type != "cuda":
        raise ValueError(f"stft_magnitude_backward_kernel runs on cuda or cpu, not {ext.device}")
    fn = _backward_launcher()
    rows = ext.reshape(-1, ext.shape[-1])
    gm = grad_mag.contiguous()
    with analytic_cost(*stft_magnitude_backward_cost(rows.shape[0], rows.shape[1], max_frames, n_fft)):
        out = torch.empty_like(rows)
        fft_len, tw, tab_a, tab_b = _tables(n_fft, ext.device)
        with torch.cuda.device(ext.device):
            stream = torch.cuda.current_stream(ext.device).cuda_stream
            rc = fn(
                rows.data_ptr(), window.data_ptr(), tw.data_ptr(), tab_a.data_ptr(),
                None if tab_b is None else tab_b.data_ptr(), gm.data_ptr(), out.data_ptr(),
                rows.shape[0], rows.shape[1], n_fft, hop, max_frames, fft_len, seg_frames, stream,
            )
    if rc != 0:
        raise RuntimeError(f"stft_magnitude backward kernel launch failed: CUDA error {rc}")
    stft_magnitude_backward_kernel.launches += 1
    return out.reshape(ext.shape)


stft_magnitude_backward_kernel.launches = 0


class StftMagnitudeFn(torch.autograd.Function):
    """|STFT| with a hand-written backward: the forward kernel, then the
    backward kernel on the saved ext (the spectrum is recomputed, not
    saved).  Only ext is differentiated; the window is a constant."""

    @staticmethod
    def forward(ctx, ext, n_fft, hop, max_frames, window):
        ctx.save_for_backward(ext, window)
        ctx.cfg = (n_fft, hop, max_frames)
        return _forward(ext, n_fft, hop, max_frames, window)

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_mag):
        ext, window = ctx.saved_tensors
        grad = stft_magnitude_backward_kernel(ext, grad_mag.contiguous(), *ctx.cfg, window)
        return grad, None, None, None, None
