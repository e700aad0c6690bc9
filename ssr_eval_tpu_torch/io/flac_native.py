"""ctypes binding to the native IO library (the port's ``csrc/ssrio.cpp``),
built by ``_native_build.py`` into ``_paths.build_dir()`` on first use.

The same functions as the JAX package's binding: `decode`, `decode_i16`,
`decode_batch`, `encode`, and the capability flags `HAS_BATCH` and
`HAS_WAV_BATCH`.  ctypes releases the GIL for the length of each C call, so
the engine's decode pool and the library's own C++ threads overlap device
work.  Reading a function or a flag builds and loads the library; a failed
build raises RuntimeError with the compiler's output (`io/audio.py` then
falls back to the pure-Python codec, with a warning).
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ssr_eval_tpu_torch._native_build import CSRC, build

_lock = threading.Lock()
_bound: ctypes.CDLL | None = None


def _lib() -> ctypes.CDLL:
    """The library with every function's argtypes and restype declared."""
    global _bound
    with _lock:
        if _bound is not None:
            return _bound
        lib = ctypes.CDLL(str(build(CSRC / "ssrio.cpp")))
        f32p, i16p, i64p, ip = (ctypes.POINTER(t) for t in (ctypes.c_float, ctypes.c_int16, ctypes.c_int64, ctypes.c_int))
        lib.ssrio_decode_flac.restype = ctypes.c_int
        lib.ssrio_decode_flac.argtypes = [ctypes.c_char_p, ctypes.POINTER(f32p), i64p, ip, ip]
        lib.ssrio_decode_flac_i16.restype = ctypes.c_int
        lib.ssrio_decode_flac_i16.argtypes = [ctypes.c_char_p, ctypes.POINTER(i16p), i64p, ip, ip]
        lib.ssrio_encode_flac.restype = ctypes.c_int
        lib.ssrio_encode_flac.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_int]
        lib.ssrio_free.restype = None
        lib.ssrio_free.argtypes = [ctypes.c_void_p]
        if hasattr(lib, "ssrio_decode_batch"):
            lib.ssrio_decode_batch.restype = ctypes.c_int
            lib.ssrio_decode_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_void_p), i64p, ip, ip, ip,
            ]
        _bound = lib
        return lib


def __getattr__(name):
    # The flags follow the built library's symbols, as the JAX binding's do.
    if name == "HAS_BATCH":
        return hasattr(_lib(), "ssrio_decode_batch")
    if name == "HAS_WAV_BATCH":
        lib = _lib()
        return hasattr(lib, "ssrio_decode_batch") and hasattr(lib, "ssrio_batch_wav_supported")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _take(ptr, count, channels):
    """Copy `count` samples out of a library buffer and free it."""
    try:
        arr = np.ctypeslib.as_array(ptr, shape=(count,)).copy()
    finally:
        _lib().ssrio_free(ptr)
    return arr.reshape(-1, channels) if channels > 1 else arr


def decode(path: str):
    """-> (float32 [n] or [n, ch] in [-1, 1], sample_rate)."""
    out = ctypes.POINTER(ctypes.c_float)()
    n, ch, sr = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    rc = _lib().ssrio_decode_flac(os.fsencode(path), ctypes.byref(out), ctypes.byref(n), ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        raise ValueError(f"ssrio: FLAC decode failed for {path} (rc={rc})")
    return _take(out, n.value * ch.value, ch.value), sr.value


def decode_i16(path: str):
    """16-bit fast path: -> (int16 [n] or [n, ch], sample_rate), or None
    when the stream is not 16-bit (the caller falls back to `decode`)."""
    out = ctypes.POINTER(ctypes.c_int16)()
    n, ch, sr = ctypes.c_int64(), ctypes.c_int(), ctypes.c_int()
    rc = _lib().ssrio_decode_flac_i16(os.fsencode(path), ctypes.byref(out), ctypes.byref(n), ctypes.byref(ch), ctypes.byref(sr))
    if rc == -8:
        return None
    if rc != 0:
        raise ValueError(f"ssrio: FLAC decode failed for {path} (rc={rc})")
    return _take(out, n.value * ch.value, ch.value), sr.value


def decode_batch(paths, n_threads: int = 0):
    """Decode many FLAC (and RIFF/WAVE) files in one native call across C++
    worker threads.

    -> list of (array, sample_rate): int16 for 16-bit streams, float32
    otherwise, [n] mono or [n, ch].  A failed file raises ValueError naming
    it.  n_threads=0 uses the hardware concurrency."""
    lib = _lib()
    n = len(paths)
    if n == 0:
        return []
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    outs = (ctypes.c_void_p * n)()
    lens = (ctypes.c_int64 * n)()
    chans = (ctypes.c_int * n)()
    srs = (ctypes.c_int * n)()
    kinds = (ctypes.c_int * n)()
    lib.ssrio_decode_batch(c_paths, n, int(n_threads), outs, lens, chans, srs, kinds)
    results = []
    try:
        for i in range(n):
            if kinds[i] < 0:
                raise ValueError(f"ssrio: FLAC decode failed for {paths[i]} (rc={kinds[i]})")
            count = lens[i] * chans[i]
            ctype = ctypes.c_int16 if kinds[i] == 0 else ctypes.c_float
            ptr = ctypes.cast(outs[i], ctypes.POINTER(ctype))
            arr = np.ctypeslib.as_array(ptr, shape=(count,)).copy()
            results.append((arr.reshape(-1, chans[i]) if chans[i] > 1 else arr, srs[i]))
    finally:
        for i in range(n):
            if outs[i]:
                lib.ssrio_free(outs[i])
    return results


def encode(path: str, data: np.ndarray, sr: int, bps: int = 16):
    """Write FLAC (fixed predictors + Rice coding; a VERBATIM subframe where
    the residual does not compress) from float data in [-1, 1]."""
    data = np.ascontiguousarray(data, dtype=np.float32)
    n, ch = (data.shape[0], 1) if data.ndim == 1 else data.shape
    rc = _lib().ssrio_encode_flac(
        os.fsencode(path), data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, ch, int(sr), int(bps)
    )
    if rc != 0:
        raise ValueError(f"ssrio: FLAC encode failed for {path} (rc={rc})")
