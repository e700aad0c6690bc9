"""Host-edge audio IO: WAV/FLAC decode + WAV/FLAC encode, dependency-free.

- a pure-NumPy RIFF/WAVE reader/writer (PCM 8/16/24/32 and float32/64),
- FLAC decode/encode through the native library (the port's `csrc/ssrio.cpp`,
  built by _native_build.py at first use, bound in io/flac_native.py), with the
  pure-Python codec (io/flac_py.py) as the fallback when that build fails:
  `flac_codec()` says which one runs, and the fallback warns once with the
  compiler's error,
- `load(path, sr, mono)` — librosa.load-compatible entry: decode, average
  channels to mono, normalize to float32 in [-1, 1], and resample
  (scipy.resample_poly semantics, or the windowed-sinc bank for
  res_type="kaiser_best").
"""

from __future__ import annotations

import struct
import threading
import warnings

import numpy as np
from scipy.signal import resample_poly as _scipy_resample_poly

from ssr_eval_tpu_torch.io.flac_py import decode_flac, encode_flac


# --------------------------------------------------------------------------
# WAV
# --------------------------------------------------------------------------

def _riff_chunks(path, raw):
    """-> (fmt tuple, data bytes) of a RIFF/WAVE byte string."""
    if raw[:4] != b"RIFF" or raw[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    pos = 12
    fmt = None
    data = None
    while pos + 8 <= len(raw):
        cid = raw[pos : pos + 4]
        size = struct.unpack("<I", raw[pos + 4 : pos + 8])[0]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", raw[pos + 8 : pos + 24])
        elif cid == b"data":
            data = raw[pos + 8 : pos + 8 + size]
        pos += 8 + size + (size & 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    return fmt, data


def read_wav(path):
    """-> (data float32 [n] or [n, ch] in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        raw = f.read()
    fmt, data = _riff_chunks(path, raw)
    audio_fmt, n_ch, sr, _, _, bits = fmt
    if audio_fmt == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        audio_fmt = 1 if bits != 32 else 3
    if audio_fmt == 1:  # PCM
        if bits == 16:
            x = np.frombuffer(data, dtype="<i2").astype(np.float32) / 32768.0
        elif bits == 32:
            x = np.frombuffer(data, dtype="<i4").astype(np.float32) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(data, dtype=np.uint8).reshape(-1, 3)
            v = (
                b[:, 0].astype(np.int32)
                | (b[:, 1].astype(np.int32) << 8)
                | (b[:, 2].astype(np.int32) << 16)
            )
            v = np.where(v >= 1 << 23, v - (1 << 24), v)
            x = v.astype(np.float32) / 8388608.0
        elif bits == 8:
            x = (np.frombuffer(data, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
        else:
            raise ValueError(f"{path}: unsupported PCM bit depth {bits}")
    elif audio_fmt == 3:  # IEEE float
        dt = "<f4" if bits == 32 else "<f8"
        x = np.frombuffer(data, dtype=dt).astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported WAV format tag {audio_fmt}")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)
    return x, sr


def write_wav(path, data, sr, subtype="PCM_16"):
    """Write float data in [-1, 1] (soundfile-compatible defaults)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n_ch = data.shape[1]
    if subtype == "PCM_16":
        pcm = np.clip(np.round(data * 32768.0), -32768, 32767).astype("<i2")
        bits, fmt_tag = 16, 1
    elif subtype == "FLOAT":
        pcm = data.astype("<f4")
        bits, fmt_tag = 32, 3
    else:
        raise ValueError(f"unsupported subtype {subtype}")
    body = pcm.tobytes()
    byte_rate = sr * n_ch * bits // 8
    block_align = n_ch * bits // 8
    with open(path, "wb") as f:
        f.write(b"RIFF")
        f.write(struct.pack("<I", 36 + len(body)))
        f.write(b"WAVE")
        f.write(b"fmt ")
        f.write(struct.pack("<IHHIIHH", 16, fmt_tag, n_ch, sr, byte_rate, block_align, bits))
        f.write(b"data")
        f.write(struct.pack("<I", len(body)))
        f.write(body)


def read_wav_i16(path):
    """16-bit PCM WAV fast path -> (int16 [n] or [n, ch], sr), or None.

    The engine ships int16 straight to the device, which rescales."""
    with open(path, "rb") as f:
        raw = f.read()
    fmt, data = _riff_chunks(path, raw)
    audio_fmt, n_ch, sr, _, _, bits = fmt
    if audio_fmt != 1 or bits != 16:
        return None
    x = np.frombuffer(data, dtype="<i2")
    if n_ch > 1:
        x = x[: (len(x) // n_ch) * n_ch].reshape(-1, n_ch)
    return x, sr


# --------------------------------------------------------------------------
# FLAC (native library first, pure-Python fallback)
# --------------------------------------------------------------------------

_native_lock = threading.Lock()
_native_state = []  # [flac_native module or None], filled at first use


def native_flac():
    """-> the io.flac_native module, or None when the library does not
    build or load (then a RuntimeWarning, once, carries the error)."""
    with _native_lock:
        if not _native_state:
            from ssr_eval_tpu_torch.io import flac_native

            try:
                flac_native.HAS_BATCH  # builds and loads the library
                _native_state.append(flac_native)
            except (RuntimeError, OSError) as err:
                warnings.warn(
                    f"the native FLAC library is unavailable, FLAC runs through the "
                    f"pure-Python codec: {err}",
                    RuntimeWarning,
                    stacklevel=3,
                )
                _native_state.append(None)
        return _native_state[0]


def flac_codec() -> str:
    """Which FLAC codec this process runs: "native" or "python"."""
    return "python" if native_flac() is None else "native"


def read_flac(path):
    """-> (float32 data [n] or [n, ch] in [-1, 1], sample_rate)."""
    nat = native_flac()
    if nat is not None:
        return nat.decode(path)
    return decode_flac(path)


def write_flac(path, data, sr):
    """Encode 16-bit FLAC (native: fixed predictors + Rice coding; the
    fallback writes VERBATIM subframes).  Both decode to the same samples."""
    data = np.asarray(data, dtype=np.float32)
    nat = native_flac()
    if nat is not None:
        return nat.encode(path, data, sr)
    return encode_flac(path, data, sr)


# --------------------------------------------------------------------------
# Generic entry points
# --------------------------------------------------------------------------

def _magic(path):
    with open(path, "rb") as f:
        return f.read(4)


def decode_audio(path):
    """Sniff the container and decode. -> (float32 data, sr)."""
    magic = _magic(path)
    if magic == b"RIFF":
        return read_wav(path)
    if magic == b"fLaC":
        return read_flac(path)
    raise ValueError(f"{path}: unsupported audio container (magic {magic!r})")


def decode_audio_i16(path):
    """16-bit fast path for any supported container -> (int16, sr) or None
    (non-16-bit sources; callers fall back to `decode_audio`)."""
    magic = _magic(path)
    if magic == b"RIFF":
        return read_wav_i16(path)
    if magic == b"fLaC":
        nat = native_flac()
        if nat is not None:
            return nat.decode_i16(path)
        data, sr, bps = decode_flac(path, raw=True)
        if bps != 16:
            return None
        return data.astype(np.int16), sr
    raise ValueError(f"{path}: unsupported audio container (magic {magic!r})")


def load(path, sr=None, mono=True, res_type="polyphase"):
    """librosa.load-compatible decode (mono mixdown, optional resample).

    res_type: 'polyphase' (scipy resample_poly design) or 'kaiser_best'
    (the resampy-parameterized windowed-sinc bank).  Returns
    (float32 [n], sample_rate).
    """
    x, native_sr = decode_audio(path)
    if mono and x.ndim > 1:
        x = x.mean(axis=1)
    if sr is None or sr == native_sr:
        return x.astype(np.float32), native_sr
    if res_type == "kaiser_best":
        from ssr_eval_tpu_torch.dsp.resample import windowed_sinc_plan

        plan = windowed_sinc_plan(int(native_sr), int(sr), len(x))
        n_out = int(plan.out_length(len(x)))
        # host apply: dense polyphase matmul in float64
        left = plan.left_ext
        n_blocks = -(-n_out // plan.up)
        need = (n_blocks - 1) * plan.down + plan.S - left
        xp = np.pad(x.astype(np.float64), (left, max(0, need - len(x))))
        idx = (
            np.arange(n_blocks)[:, None] * plan.down + np.arange(plan.S)[None, :]
        )
        y = (xp[idx] @ plan.Wd.astype(np.float64).T).reshape(-1)[:n_out]
        return y.astype(np.float32), sr
    import math

    g = math.gcd(int(native_sr), int(sr))
    y = _scipy_resample_poly(x.astype(np.float64), sr // g, native_sr // g)
    return y.astype(np.float32), sr
