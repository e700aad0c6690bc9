"""The |STFT| kernel module: its plain PyTorch version against the JAX
Pallas kernel (interpret mode on the CPU), and the wrapper's CPU dispatch
and argument checks.  The CUDA kernel itself is held against its plain
version by tests/test_torch_cuda.py and chip_smoke.py.

Tolerances are those of tests/test_pallas_stft.py: atol/rtol 1e-4 on raw
frames, 5e-4 of the largest magnitude through the reflect-extend path.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssr_eval_tpu.dsp import spectral as jsp
from ssr_eval_tpu.dsp.pallas_stft import fused_ct_stft_magnitude
from ssr_eval_tpu_torch.dsp import spectral as tsp
from ssr_eval_tpu_torch.dsp import stft_kernel
from ssr_eval_tpu_torch.dsp.stft_kernel import (
    stft_magnitude_kernel,
    stft_magnitude_plain,
)


def _win(n_fft, device="cpu"):
    return tsp.window_tensor(n_fft, n_fft, torch.device(device))


def test_plain_matches_pallas_kernel():
    n_fft, hop, mf = 2048, 441, 9
    rng = np.random.default_rng(5)
    ext = rng.standard_normal((mf - 1) * hop + n_fft).astype(np.float32)
    want = np.asarray(
        fused_ct_stft_magnitude(
            jnp.asarray(ext), n_fft, hop, mf, jsp.hann_window(n_fft), interpret=True
        )
    )
    got = stft_magnitude_plain(torch.from_numpy(ext), n_fft, hop, mf, _win(n_fft)).numpy()
    assert got.shape == want.shape == (mf, n_fft // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_plain_matches_pallas_kernel_through_extend():
    cfg = tsp.StftConfig(n_fft=2048, hop=441)
    L = 30000
    rng = np.random.default_rng(0)
    t = np.arange(L) / 44100.0
    x = (
        0.5 * np.sin(2 * np.pi * 440 * t)
        + 0.2 * np.sin(2 * np.pi * 9000 * t)
        + 0.02 * rng.standard_normal(L)
    ).astype(np.float32)
    mf = cfg.max_frames(L)
    ext_j = jsp._extend(jnp.asarray(x), L, cfg.pad)
    want = np.asarray(
        fused_ct_stft_magnitude(ext_j, cfg.n_fft, cfg.hop, mf, jsp.hann_window(cfg.win), interpret=True)
    )
    got = tsp.stft_magnitude(
        torch.from_numpy(x)[None], torch.tensor([L]), cfg, mf
    )[0].numpy()
    assert np.abs(got - want).max() / want.max() < 5e-4


def test_wrapper_takes_plain_version_on_cpu():
    rng = np.random.default_rng(1)
    ext = torch.from_numpy(rng.standard_normal((3, 10 * 480 + 2229)).astype(np.float32))
    before = stft_magnitude_kernel.launches
    got = stft_magnitude_kernel(ext, 2229, 480, 11, _win(2229))
    assert stft_magnitude_kernel.launches == before  # no kernel launched
    want = stft_magnitude_plain(ext, 2229, 480, 11, _win(2229))
    assert got.shape == (3, 11, 1115)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize(
    "case,err",
    [
        ("float64", TypeError),
        ("short", ValueError),
        ("n_fft", ValueError),
        ("window", ValueError),
        ("strided", ValueError),
    ],
)
def test_wrapper_rejects_bad_arguments(case, err):
    n_fft, hop, mf = 512, 128, 6
    ext = torch.zeros(2, (mf - 1) * hop + n_fft)
    win = _win(n_fft)
    args = dict(ext=ext, n_fft=n_fft, hop=hop, max_frames=mf, window=win)
    if case == "float64":
        args["ext"] = ext.double()
    elif case == "short":
        args["ext"] = ext[:, :-1].contiguous()
    elif case == "n_fft":
        args.update(n_fft=8192, window=_win(8192), ext=torch.zeros(2, 8192))
        args["max_frames"] = 1
    elif case == "window":
        args["window"] = win[:-1].contiguous()
    elif case == "strided":
        args["ext"] = torch.zeros(2, 2 * ext.shape[1])[:, ::2]
    with pytest.raises(err):
        stft_magnitude_kernel(**args)


# ----------------------------------------------------------------------
# The CUDA kernel's algorithm, run in NumPy float32 with the wrapper's own
# tables: the Stockham passes (radix 16, then 2, 4 or 8), the split of the
# half-length complex FFT, and Bluestein's convolution with |conv| as the
# magnitude.  Index or table faults show here, where there is no card.
# Tolerance: 2e-6 of max |X| against a float64 rfft (a float32 FFT rounds
# at ~1e-7 of the peak).
# ----------------------------------------------------------------------


def _c64(tab):
    return (tab[:, 0] + 1j * tab[:, 1]).astype(np.complex64)


def _dft4(a0, a1, a2, a3):
    t0, t1, t2, t3 = a0 + a2, a0 - a2, a1 + a3, -1j * (a1 - a3)
    return [t0 + t2, t1 + t3, t0 - t2, t1 - t3]


def _dft_rows(v):
    """The kernel's radix-R register DFT, natural order, over v's last axis."""
    R = v.shape[-1]
    cols = [v[:, r] for r in range(R)]
    h = np.float32(np.sqrt(0.5))
    c1, s1 = np.float32(np.cos(np.pi / 8)), np.float32(np.sin(np.pi / 8))
    if R == 2:
        out = [cols[0] + cols[1], cols[0] - cols[1]]
    elif R == 4:
        out = _dft4(*cols)
    elif R == 8:
        e = _dft4(cols[0], cols[2], cols[4], cols[6])
        o = _dft4(cols[1], cols[3], cols[5], cols[7])
        o = [o[0], o[1] * np.complex64(h - 1j * h), -1j * o[2], o[3] * np.complex64(-h - 1j * h)]
        out = [e[k] + o[k] for k in range(4)] + [e[k] - o[k] for k in range(4)]
    else:  # 16 = 4 x 4, as dft16 in the kernel
        y = [_dft4(*(cols[n1 + 4 * n2] for n2 in range(4))) for n1 in range(4)]  # y[n1][k1]
        w = {1: c1 - 1j * s1, 2: h - 1j * h, 3: s1 - 1j * c1, 4: -1j, 6: -h - 1j * h, 9: -c1 + 1j * s1}
        y = [[y[n1][k1] * np.complex64(w[n1 * k1]) if n1 * k1 else y[n1][k1] for k1 in range(4)] for n1 in range(4)]
        z = [_dft4(*(y[n1][k1] for n1 in range(4))) for k1 in range(4)]  # z[k1][k2]
        out = [z[k % 4][k // 4] for k in range(16)]
    return np.stack(out, axis=-1).astype(np.complex64)


def _stockham_np(z, twiddle):
    """The kernel's in-place Stockham FFT of z (complex64, power-of-two length)."""
    P = z.shape[0]
    tw = _c64(twiddle)
    ns, off = 1, 0
    for R in stft_kernel.stockham_radices(P):
        span = P // R
        j = np.arange(span)
        k = j & (ns - 1)
        r = np.arange(R)
        v = z[j[:, None] + span * r[None, :]].copy()
        if ns > 1:
            v[:, 1:] *= tw[off + (r[None, 1:] - 1) * ns + k[:, None]]
        out = np.empty_like(z)
        out[((j - k) * R + k)[:, None] + ns * r[None, :]] = _dft_rows(v)
        z, off, ns = out, off + (R - 1) * ns, ns * R
    return z


def _kernel_algorithm_np(frames, win, n_fft):
    """|X| of each row of `frames` [F, n_fft] as the CUDA kernel computes it."""
    plan = stft_kernel._fft_plan(n_fft)
    v = (frames * win).astype(np.float32)
    K = n_fft // 2 + 1
    out = []
    for row in v:
        if plan.kind == "split":
            P = plan.fft_len
            Z = _stockham_np((row[0::2] + 1j * row[1::2]).astype(np.complex64), plan.twiddle)
            k = np.arange(P + 1)
            zk, zc = Z[k & (P - 1)], np.conj(Z[(P - k) & (P - 1)])
            X = 0.5 * (zk + zc) + _c64(plan.table_a) * (-0.5j * (zk - zc))
        else:
            a = np.zeros(plan.fft_len, np.complex64)
            a[:n_fft] = row * _c64(plan.table_a)
            A = _stockham_np(a, plan.twiddle)
            X = _stockham_np(np.conj(A) * _c64(plan.table_b), plan.twiddle)[:K]
        out.append(np.abs(X.astype(np.complex64)))
    return np.stack(out)


@pytest.mark.parametrize("n_fft", [1, 2, 17, 743, 2048, 2049, 2229, 4095, 4096])
def test_kernel_algorithm_matches_float64_rfft(n_fft):
    rng = np.random.default_rng(n_fft)
    frames = rng.standard_normal((3, n_fft)).astype(np.float32)
    win = rng.uniform(0.25, 1.0, n_fft).astype(np.float32)
    got = _kernel_algorithm_np(frames, win, n_fft)
    want = np.abs(np.fft.rfft(frames.astype(np.float64) * win.astype(np.float64), axis=-1))
    assert got.shape == want.shape == (3, n_fft // 2 + 1)
    rel = np.abs(got - want).max() / np.abs(want).max()
    print(f"n_fft={n_fft} kind={stft_kernel._fft_plan(n_fft).kind} max err / max |X| = {rel:.3e}")
    assert rel <= 2e-6


@pytest.mark.parametrize(
    "n_fft,kind,fft_len",
    [
        (1, "bluestein", 1), (2, "split", 1), (17, "bluestein", 32), (743, "bluestein", 2048),
        (2047, "bluestein", 4096), (2048, "split", 1024), (2229, "bluestein", 4096),
        (2731, "bluestein", 4096), (2732, "bluestein", 8192), (4096, "split", 2048),
    ],
)
def test_fft_plan_kind_length_and_tables(n_fft, kind, fft_len):
    plan = stft_kernel._fft_plan(n_fft)
    assert (plan.kind, plan.fft_len) == (kind, fft_len)
    # fft_len >= n_fft + n_fft//2 keeps the first n_fft//2 + 1 bins of
    # Bluestein's circular convolution free of wrap-around.
    assert kind == "split" or fft_len >= n_fft + n_fft // 2
    n_tw = 1
    if fft_len > 1:
        ns, n_tw = 1, 0
        for R in stft_kernel.stockham_radices(fft_len):
            n_tw, ns = n_tw + (R - 1) * ns, ns * R
        assert ns == fft_len
    tables = [plan.twiddle, plan.table_a] + ([] if kind == "split" else [plan.table_b])
    for tab in tables:
        assert tab.dtype == np.float32 and tab.ndim == 2 and tab.shape[1] == 2
        assert tab.flags["C_CONTIGUOUS"]
        # every table entry is a unit root up to float32 rounding, except D
        if tab is not plan.table_b:
            np.testing.assert_allclose(np.hypot(tab[:, 0], tab[:, 1]), 1.0, atol=1e-6)
    assert plan.twiddle.shape[0] == n_tw
    assert plan.table_a.shape[0] == (n_fft // 2 + 1 if kind == "split" else n_fft)
    assert kind == "split" or plan.table_b.shape[0] == fft_len
