"""In-process MP3 codec via the system LAME library (ctypes, no subprocess).

The reference's MP3 degradation shells out to ``sox -C <kbps>`` per file
(reference eval.py:302-325) — and sox's MP3 support is itself libmp3lame.
Binding the library directly removes the subprocess + temp-file round trip
and the sox/ffmpeg PATH dependency: encode with the ``lame_*`` API, decode
with LAME's built-in MPEG decoder (the ``hip_*`` API).

The LAME C API is stable ABI; prototypes are declared here so no header is
needed.  Everything degrades gracefully: `available()` is False when the
shared library is missing, and `degrade.codec` falls back to sox/ffmpeg.
"""

from __future__ import annotations

import ctypes
import functools
import threading

import numpy as np

# libmp3lame is NOT thread-safe: the lame_* encoder and hip_* decoder
# share library-global tables, and concurrent encode+decode calls from
# the engine's codec pool produce nondeterministic PCM (run-to-run metric
# changes on one utterance per batch).  Per-call handles
# (gfp/hip) are not enough; ALL entry into the library is serialized
# here.  Codec work still overlaps device compute and host decode (the
# lock only serializes codec-vs-codec), and the CLI fallbacks keep full
# parallelism (separate processes).
_lame_lock = threading.Lock()

_LIB_NAMES = ("libmp3lame.so.0", "libmp3lame.so", "libmp3lame.dylib")


class Mp3Data(ctypes.Structure):
    """lame.h mp3data_struct — declared so ctypes owns the layout (no
    hand-maintained byte offsets)."""

    _fields_ = [
        ("header_parsed", ctypes.c_int),
        ("stereo", ctypes.c_int),
        ("samplerate", ctypes.c_int),
        ("bitrate", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("mode_ext", ctypes.c_int),
        ("framesize", ctypes.c_int),
        ("nsamp", ctypes.c_ulong),
        ("totalframes", ctypes.c_int),
        ("framenum", ctypes.c_int),
    ]

# One MPEG frame decodes to at most 1152 samples/channel; hip can flush
# several buffered frames per call, so size the PCM buffers generously.
_PCM_BUF = 1 << 16

_MONO = 3  # MPEG mode enum: 0=stereo 1=joint 2=dual 3=mono


@functools.lru_cache(maxsize=1)
def _lib():
    lib = None
    for name in _LIB_NAMES:
        try:
            lib = ctypes.CDLL(name)
            break
        except OSError:
            continue
    if lib is None:
        return None
    c_void_p, c_int, c_ulong = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulong
    shortp = ctypes.POINTER(ctypes.c_short)
    ubytep = ctypes.POINTER(ctypes.c_ubyte)
    try:
        lib.lame_init.restype = c_void_p
        for f in (
            "lame_set_in_samplerate",
            "lame_set_out_samplerate",
            "lame_set_num_channels",
            "lame_set_brate",
            "lame_set_mode",
            "lame_set_quality",
            "lame_set_bWriteVbrTag",
        ):
            fn = getattr(lib, f)
            fn.argtypes = [c_void_p, c_int]
            fn.restype = c_int
        lib.lame_init_params.argtypes = [c_void_p]
        lib.lame_init_params.restype = c_int
        lib.lame_encode_buffer.argtypes = [c_void_p, shortp, shortp, c_int, ubytep, c_int]
        lib.lame_encode_buffer.restype = c_int
        lib.lame_encode_flush.argtypes = [c_void_p, ubytep, c_int]
        lib.lame_encode_flush.restype = c_int
        lib.lame_close.argtypes = [c_void_p]
        lib.lame_close.restype = c_int
        lib.hip_decode_init.restype = c_void_p
        lib.hip_decode1_headers.argtypes = [
            c_void_p, ubytep, ctypes.c_size_t, shortp, shortp,
            ctypes.POINTER(Mp3Data),
        ]
        lib.hip_decode1_headers.restype = c_int
        lib.hip_decode_exit.argtypes = [c_void_p]
        lib.hip_decode_exit.restype = c_int
    except AttributeError:
        return None
    return lib


def available() -> bool:
    return _lib() is not None


def encode_mp3(x: np.ndarray, sr: int, kbps: int) -> bytes:
    """CBR-encode mono float32/float64 [-1, 1] audio -> MP3 bytes."""
    lib = _lib()
    if lib is None:
        raise RuntimeError("libmp3lame is not available")
    x = np.asarray(x)
    assert x.ndim == 1, x.shape
    pcm = np.clip(np.round(x.astype(np.float64) * 32768.0), -32768, 32767).astype(
        np.int16
    )
    with _lame_lock:
        return _encode_locked(lib, pcm, sr, kbps)


def _encode_locked(lib, pcm, sr, kbps):
    gfp = lib.lame_init()
    if not gfp:
        raise RuntimeError("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sr))
        # Forbid LAME's automatic resampling: the reference pipeline decodes
        # back at the source rate (eval.py:311-317).
        lib.lame_set_out_samplerate(gfp, int(sr))
        lib.lame_set_num_channels(gfp, 1)
        lib.lame_set_mode(gfp, _MONO)
        lib.lame_set_brate(gfp, int(kbps))
        lib.lame_set_bWriteVbrTag(gfp, 0)
        if lib.lame_init_params(gfp) < 0:
            raise RuntimeError(
                f"lame_init_params rejected sr={sr} kbps={kbps} (not a valid "
                "MPEG rate/bitrate combination)"
            )
        n = pcm.shape[0]
        out = bytearray()
        buf = (ctypes.c_ubyte * (int(1.25 * n) + 7200 + 7200))()
        sp = pcm.ctypes.data_as(ctypes.POINTER(ctypes.c_short))
        r = lib.lame_encode_buffer(gfp, sp, sp, n, buf, len(buf))
        if r < 0:
            raise RuntimeError(f"lame_encode_buffer error {r}")
        out += bytes(buf[:r])
        r = lib.lame_encode_flush(gfp, buf, len(buf))
        if r < 0:
            raise RuntimeError(f"lame_encode_flush error {r}")
        out += bytes(buf[:r])
        return bytes(out)
    finally:
        lib.lame_close(gfp)


def decode_mp3(data: bytes) -> tuple[np.ndarray, int]:
    """Decode MP3 bytes -> (float32 mono [-1, 1], samplerate).

    Stereo streams are averaged to mono (matching the load(mono=True)
    convention used across the IO edge).
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("libmp3lame is not available")
    with _lame_lock:
        return _decode_locked(lib, data)


def _decode_locked(lib, data):
    hip = lib.hip_decode_init()
    if not hip:
        raise RuntimeError("hip_decode_init failed")
    pcm_l = (ctypes.c_short * _PCM_BUF)()
    pcm_r = (ctypes.c_short * _PCM_BUF)()
    mp3data = Mp3Data()
    chunks_l, chunks_r = [], []
    sr = 0
    stereo = 1
    try:
        view = memoryview(bytes(data))
        CHUNK = 16384
        pos = 0
        while True:
            if pos < len(view):
                piece = bytes(view[pos : pos + CHUNK])
                pos += len(piece)
            else:
                piece = b""  # drain the decoder's internal buffer
            blen = len(piece)
            bptr = (ctypes.c_ubyte * max(blen, 1)).from_buffer_copy(
                piece if blen else b"\x00"
            )
            while True:
                n = lib.hip_decode1_headers(
                    hip, bptr, blen, pcm_l, pcm_r, ctypes.byref(mp3data)
                )
                blen = 0  # the buffer is consumed on the first call
                if n < 0:
                    raise RuntimeError(f"hip_decode error {n}")
                if n == 0:
                    break
                if not sr and mp3data.header_parsed:
                    stereo = int(mp3data.stereo)
                    sr = int(mp3data.samplerate)
                chunks_l.append(np.frombuffer(pcm_l, np.int16, n).copy())
                if stereo == 2:
                    chunks_r.append(np.frombuffer(pcm_r, np.int16, n).copy())
            if pos >= len(view) and piece == b"":
                break
    finally:
        lib.hip_decode_exit(hip)
    if not chunks_l:
        raise RuntimeError("no audio frames decoded")
    left = np.concatenate(chunks_l).astype(np.float32) / 32768.0
    if stereo == 2 and chunks_r:
        right = np.concatenate(chunks_r).astype(np.float32) / 32768.0
        left = 0.5 * (left + right[: left.shape[0]])
    return left, int(sr)
