"""MP3 compression degradation: the host codec edge (reference
eval.py:302-325).

The preferred backend is the system LAME library bound in-process
(`io/mp3_lame.py`, the encoder sox itself wraps), with sox / ffmpeg CLIs
as the fallback.  The decode-side alignment (cross-correlation argmax
shift, eval.py:319-320) runs on the caller's device through the FFT
correlator, and the aligned result is cached as FLAC next to the source
like the reference (eval.py:321).

Without any codec this raises `CodecUnavailableError` instead of
corrupting the run (the reference never checked `os.system` return codes).
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np
import torch

from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.dsp.correlate import align_by_correlation
from ssr_eval_tpu_torch.io import mp3_lame
from ssr_eval_tpu_torch.io.audio import load, write_flac, write_wav


class CodecUnavailableError(RuntimeError):
    pass


# (sr, kbps) combinations LAME has deterministically rejected in this
# process, so later utterances of a doomed spec go straight to the CLI
# fallback instead of paying the failed LAME attempt again.
_lame_rejections: set = set()

# Error-message markers of LAME's deterministic (sr, kbps) rejections, as
# raised by io/mp3_lame.py.  Anything else (allocation failures like
# lame_init/hip_decode_init) is transient and surfaces instead of quietly
# rerouting to a slower codec.
_REJECTION_MARKERS = ("lame_init_params rejected", "Hz audio for a")


def _cli_backend():
    """CLI codec priority chain (shared by detection and the LAME fallback)."""
    if shutil.which("sox"):
        return "sox"
    if shutil.which("ffmpeg"):
        return "ffmpeg"
    return None


def detect_backend():
    if mp3_lame.available():
        return "lame"
    return _cli_backend()


def _encode_decode_mp3(src_wav: str, kbps: int, backend: str, workdir: str) -> str:
    mp3 = os.path.join(workdir, "enc.mp3")
    out = os.path.join(workdir, "dec.wav")
    if backend == "sox":
        subprocess.run(["sox", src_wav, "-C", str(kbps), mp3], check=True)
        subprocess.run(["sox", mp3, out], check=True)
    elif backend == "ffmpeg":
        subprocess.run(
            ["ffmpeg", "-y", "-loglevel", "error", "-i", src_wav, "-b:a", f"{kbps}k", mp3],
            check=True,
        )
        subprocess.run(["ffmpeg", "-y", "-loglevel", "error", "-i", mp3, out], check=True)
    else:
        raise CodecUnavailableError(backend)
    return out


def unify_length(x: np.ndarray, target: np.ndarray):
    """Crop or zero-pad x to len(target) (reference eval.py:292-300)."""
    if x.shape[0] == target.shape[0]:
        return x, target
    if x.shape[0] > target.shape[0]:
        return x[: target.shape[0]], target
    out = np.zeros_like(target)
    out[: x.shape[0]] = x
    return out, target


def mp3_degrade(file: str, x: np.ndarray, sr: int, kbps: int, cache_path: str | None = None, *, device=None):
    """Encode -> decode -> align one utterance; -> aligned float32 [len(x)].

    Mirrors reference mp3_encoding (eval.py:302-325): round trip through
    the codec at `kbps`, load at `sr`, unify length against `x`, shift by
    the cross-correlation argmax (on `device`: None is the card, "cpu" the
    CPU), optionally cache as FLAC, and assert the result differs from the
    input.
    """
    dev = resolve_device(device)
    backend = detect_backend()
    if backend is None:
        raise CodecUnavailableError(
            "MP3 degradation requires a host codec (the LAME library, sox, "
            "or ffmpeg); none was found. Install one or drop "
            "setting_mp3_compression."
        )
    if backend == "lame" and (sr, kbps) in _lame_rejections:
        backend = _cli_backend()
        if backend is None:
            raise CodecUnavailableError(
                f"LAME failed (rejects sr={sr} kbps={kbps}) and no "
                "sox/ffmpeg CLI is available to fall back to"
            )
    if backend == "lame":
        try:
            # encode_mp3 pins the MP3 rate to sr, so dec_sr == sr; the guard
            # keeps a library that refuses the pin from corrupting shapes.
            y, dec_sr = mp3_lame.decode_mp3(mp3_lame.encode_mp3(x, sr, kbps))
            if dec_sr != sr:
                raise RuntimeError(f"LAME produced {dec_sr} Hz audio for a {sr} Hz request")
        except RuntimeError as lame_err:
            # LAME rejects non-MPEG rate / bitrate combinations that the CLI
            # codecs handle by resampling internally: retry there, and
            # remember the verdict.  Other LAME failures raise.
            if not any(m in str(lame_err) for m in _REJECTION_MARKERS):
                raise
            _lame_rejections.add((sr, kbps))
            backend = _cli_backend()
            if backend is None:
                raise CodecUnavailableError(
                    f"LAME failed ({lame_err}) and no sox/ffmpeg CLI is "
                    "available to fall back to"
                ) from lame_err
    if backend != "lame":  # CLI backends round-trip through files
        with tempfile.TemporaryDirectory() as td:
            src = os.path.join(td, "src.wav")
            write_wav(src, x, sr)
            dec = _encode_decode_mp3(src, kbps, backend, td)
            y, _ = load(dec, sr=sr)
    y, x = unify_length(y.astype(np.float32), x)
    shifted = align_by_correlation(
        torch.from_numpy(np.ascontiguousarray(y)).to(dev),
        torch.from_numpy(np.ascontiguousarray(x, dtype=np.float32)).to(dev),
    ).cpu().numpy()
    if cache_path is not None:
        write_flac(cache_path, shifted[..., None], sr)
    assert shifted.shape == x.shape, str((shifted.shape, x.shape))
    assert float(np.sum(shifted - x)) != 0.0
    return shifted
