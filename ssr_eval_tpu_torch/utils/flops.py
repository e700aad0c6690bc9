"""FLOP and byte accounting for the port's device programs, for MFU and
roofline reporting (counterpart of ``ssr_eval_tpu/utils/flops.py``).

XLA reports a compiled program's FLOP and bytes; PyTorch runs eagerly and
has no compiled program to ask, so `count_cost(fn, *args)` runs one call
and counts it as it goes:

- FLOP: `torch.utils.flop_counter.FlopCounterMode` (matmuls and
  convolutions, forward and backward), plus two terms it cannot see, both
  from one analytic formula whatever computes them:
  - every ``torch.fft`` op (aten ``_fft_r2c`` / ``_fft_c2r`` /
    ``_fft_c2c``): 2.5 N log2 N per real transform of length N, 5 N log2 N
    per complex one;
  - the |STFT| kernel's wrapper (`dsp.stft_kernel`), which calls its CUDA
    library directly, not through the dispatcher: it reports
    `stft_magnitude_cost` (2.5 N log2 N per frame + 3 per bin for |.|) on
    the card and on the CPU alike, and the ops of its plain version are
    not counted again, so the count is the same on both devices.  Its
    backward kernel reports `stft_magnitude_backward_cost` (on the CPU the
    plain backward's own ops are counted instead).
- bytes_accessed: the sum of each op's input and output tensor bytes (a
  TorchDispatchMode; views move no bytes and are skipped), with the
  kernel's analytic bytes (its input read once, its output written once).
  This is unfused traffic: what the ops would move if nothing stayed in
  cache or registers between them, an upper bound on what the card moves.

`EvalEngine` records each distinct batch program it dispatches (its key,
argument shapes and call count); `engine_program_costs` runs each once
more on inputs of those shapes and counts it.  `chip_peaks` maps the
card's name to datasheet peaks and `utilization` turns costs and a rate
into TFLOP/s, GB/s and shares of the peaks.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.utils._python_dispatch import TorchDispatchMode, _get_current_dispatch_mode_stack
from torch.utils._pytree import tree_leaves

_aten = torch.ops.aten
_FFT_OPS = {_aten._fft_r2c.default, _aten._fft_c2r.default, _aten._fft_c2c.default}


def fft_flops(n: int, transforms: int, complex_input: bool = False) -> float:
    """2.5 N log2 N per real transform of length N, 5 N log2 N per complex."""
    if n <= 1:
        return 0.0
    return (5.0 if complex_input else 2.5) * n * math.log2(n) * transforms


def stft_magnitude_cost(rows: int, ext_len: int, frames: int, n_fft: int) -> tuple[float, float]:
    """(FLOP, bytes) of one |STFT| call over [rows, ext_len] -> [rows,
    frames, n_fft//2 + 1]: a real transform per frame and 3 per bin for the
    magnitude; ext read once, the magnitudes written once, and 3 n_fft
    floats of window and tables."""
    n_bins = n_fft // 2 + 1
    flops = rows * frames * (fft_flops(n_fft, 1) + 3 * n_bins)
    return flops, 4.0 * (rows * ext_len + rows * frames * n_bins + 3 * n_fft)


def stft_magnitude_backward_cost(rows: int, ext_len: int, frames: int, n_fft: int) -> tuple[float, float]:
    """(FLOP, bytes) of one |STFT| backward call: two transforms per frame
    (the spectrum again, then the inverse) and ~10 operations per bin for
    g X / |X|; ext and the upstream gradient read once, the gradient of ext
    written once, the window read."""
    n_bins = n_fft // 2 + 1
    flops = rows * frames * (2 * fft_flops(n_fft, 1) + 10 * n_bins)
    return flops, 4.0 * (2 * rows * ext_len + rows * frames * n_bins + n_fft)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _fft_op_flops(func, args, out) -> float:
    """The analytic count of one aten FFT op: (input, dims, ...)."""
    x, dims = args[0], args[1]
    if func is _aten._fft_c2r.default:
        sizes = [out.shape[d] for d in dims]  # the real output's lengths
    else:
        sizes = [x.shape[d] for d in dims]
    n = math.prod(sizes)
    transforms = x.numel() // math.prod(x.shape[d] for d in dims)
    return fft_flops(n, transforms, complex_input=func is _aten._fft_c2c.default)


class _CostMode(TorchDispatchMode):
    """Counts bytes of every non-view op and the FLOP of FFT ops; kernel
    wrappers add their analytic cost through `analytic_cost`, which hides
    their own ops from the count."""

    def __init__(self):
        super().__init__()
        self.bytes = 0.0
        self.fft_flops = 0.0
        self.kernel_flops = 0.0
        self.hidden = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.hidden and not func.is_view:
            self.bytes += _nbytes((args, kwargs)) + _nbytes(out)
            if func in _FFT_OPS:
                self.fft_flops += _fft_op_flops(func, args, out)
        return out


@contextlib.contextmanager
def analytic_cost(flops: float, nbytes: float):
    """Inside a `count_cost` run: add (flops, nbytes) for the enclosed call
    and count none of its own ops.  Outside one: nothing."""
    modes = [m for m in _get_current_dispatch_mode_stack() if isinstance(m, _CostMode)]
    for m in modes:
        m.kernel_flops += flops
        m.bytes += nbytes
        m.hidden += 1
    try:
        yield
    finally:
        for m in modes:
            m.hidden -= 1


def count_cost(fn, *args, **kwargs) -> dict:
    """{"flops", "bytes_accessed"} of ONE call fn(*args, **kwargs), with
    the FLOP split into "matmul_conv_flops" (FlopCounterMode), "fft_flops"
    (torch.fft ops) and "kernel_flops" (hand-written kernels' analytic
    reports).  The call runs for real, on its arguments' device."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc, _CostMode() as cm:
        fn(*args, **kwargs)
    counted = float(fc.get_total_flops())
    return {
        "flops": counted + cm.fft_flops + cm.kernel_flops,
        "bytes_accessed": cm.bytes,
        "matmul_conv_flops": counted,
        "fft_flops": cm.fft_flops,
        "kernel_flops": cm.kernel_flops,
    }


def abstract_args(args) -> tuple:
    """Tensors -> (shape, dtype) pairs, kept without a reference to their
    buffers (an engine records its programs' arguments this way)."""
    return tuple((tuple(a.shape), a.dtype) for a in args)


def materialize(specs, device, seed: int = 0) -> tuple:
    """(shape, dtype) pairs -> tensors on `device`: floating tensors drawn
    N(0, 0.1^2) from `seed`, integer tensors (the engine's length vectors)
    filled with the last dimension of the floating tensor before them, the
    longest length a batch of that shape holds.  Costs depend on shapes
    only."""
    g = torch.Generator().manual_seed(seed)
    out, last = [], 1
    for shape, dtype in specs:
        if dtype.is_floating_point:
            t = 0.1 * torch.randn(shape, generator=g, dtype=dtype)
            last = shape[-1] if shape else 1
        else:
            t = torch.full(shape, last, dtype=dtype)
        out.append(t.to(device))
    return tuple(out)


def engine_program_costs(engine) -> dict:
    """Per-program costs for every batch program an EvalEngine has
    dispatched: {label: {"flops", "bytes_accessed", "calls", ...}}.  Each
    program runs once more on inputs of its recorded shapes (the kernel's
    launch count moves with it)."""
    out = {}
    for key, (fn, specs) in getattr(engine, "_cost_args", {}).items():
        # Full key in the label: distinct programs (per native_sr/bucket)
        # must not collapse onto one entry.
        label = "_".join(str(p) for p in key)
        c = count_cost(fn, *materialize(specs, engine.device))
        c["calls"] = engine._cost_calls.get(key, 0)
        out[label] = c
    return out


# Datasheet peaks (NVIDIA H100 datasheet; dense, without sparsity), keyed
# by a substring of torch.cuda.get_device_name(): (fp32 TFLOP/s outside
# the tensor cores, bf16 TFLOP/s on the tensor cores, HBM GB/s).  First
# match wins, so the PCIe and NVL parts come before the SXM part, whose
# name ("NVIDIA H100 80GB HBM3") carries neither.
_PEAKS = (
    ("H100 PCIe", "H100 PCIe", (51.0, 756.0, 2000.0)),
    ("H100 NVL", "H100 NVL", (60.0, 835.0, 3900.0)),
    ("H100", "H100 SXM", (67.0, 989.0, 3350.0)),
)


def chip_peaks(device=None) -> dict:
    """{"device_kind", "datasheet", "fp32_tflops", "bf16_tflops",
    "hbm_gbps"} for `device` (None: the CUDA card, which must exist); an
    unknown card or the CPU reports its peaks as None rather than
    guessing."""
    from ssr_eval_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"device_kind": "cpu", "datasheet": None, "fp32_tflops": None, "bf16_tflops": None,
                "hbm_gbps": None}
    kind = torch.cuda.get_device_name(dev)
    for sub, part, (fp32, bf16, bw) in _PEAKS:
        if sub in kind:
            return {"device_kind": kind, "datasheet": f"NVIDIA {part} (datasheet, dense)",
                    "fp32_tflops": fp32, "bf16_tflops": bf16, "hbm_gbps": bw}
    return {"device_kind": kind, "datasheet": None, "fp32_tflops": None, "bf16_tflops": None, "hbm_gbps": None}


def utilization(flops_per_call, bytes_per_call, calls_per_s, peaks) -> dict:
    """Throughput + peaks -> {tflops_per_s, hbm_gbps, mfu_vs_bf16_peak,
    mfu_vs_fp32_peak, pct_of_hbm_peak} (a share is left out where its peak
    is unknown).  The port computes in fp32 without TF32, so the fp32 share
    is the one its convolutions can reach; the bf16 share is the JAX
    package's key."""
    tflops = flops_per_call * calls_per_s / 1e12
    gbps = bytes_per_call * calls_per_s / 1e9
    out = {"tflops_per_s": round(tflops, 3), "hbm_gbps": round(gbps, 2)}
    if peaks.get("bf16_tflops"):
        out["mfu_vs_bf16_peak"] = round(tflops / peaks["bf16_tflops"], 4)
    if peaks.get("fp32_tflops"):
        out["mfu_vs_fp32_peak"] = round(tflops / peaks["fp32_tflops"], 4)
    if peaks.get("hbm_gbps"):
        out["pct_of_hbm_peak"] = round(100.0 * gbps / peaks["hbm_gbps"], 2)
    return out
