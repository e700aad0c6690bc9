"""Device resolution, DSP precision pins and cached device constants.

Every entry point of the package runs on the CUDA card unless the caller
asks for the CPU with ``device="cpu"``.  Without a card and without that
request it raises instead of quietly running on the CPU.

The precision pins keep float32 matrix products and convolutions in full
float32: TF32 keeps about three decimal digits, and one reduced-precision
pass is enough to move the spectral floors the metrics read.

`device_cache` caches the device tensors that the DSP builds once (windows,
FFT tables, filter responses, resampler weights).  A CUDA graph reads such
a constant at the address it had when the graph was captured, so the
engine captures inside `held_constants()`, which hands it every constant
read there to keep alive after its cache evicts it.
"""

from __future__ import annotations

import contextlib
import contextvars
import functools

import torch

_HELD = contextvars.ContextVar("held_constants", default=None)


def pin_precision() -> None:
    """Full-float32 matmuls and convolutions on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """-> the torch.device to run on; pins DSP precision.

    None means the card.  "cpu" (or a CPU torch.device) runs the plain
    PyTorch versions of the kernels.  Anything that needs a card raises
    when there is none.
    """
    pin_precision()
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch path on the CPU"
        )
    return dev


def device_cache(maxsize: int):
    """`functools.lru_cache(maxsize)` for a function that returns device
    tensors (or a structure of them).  Inside `held_constants()` every
    result it returns, hit or miss, is also appended to that block's list."""

    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def get(*args, **kwargs):
            out = cached(*args, **kwargs)
            held = _HELD.get()
            if held is not None:
                held.append(out)
            return out

        get.cache_clear = cached.cache_clear
        get.cache_info = cached.cache_info
        return get

    return wrap


@contextlib.contextmanager
def held_constants():
    """-> a list that collects every `device_cache` result returned inside
    the block."""
    held = []
    token = _HELD.set(held)
    try:
        yield held
    finally:
        _HELD.reset(token)
