"""The port's native FLAC IO (its build by ssr_eval_tpu_torch._native_build, io.flac_native,
io.audio, the engine's native batch decode) on the CPU.

The library is the port's own g++ build of its csrc/ssrio.cpp (a copy of
native/ssrio.cpp) under ssr_eval_tpu_torch/_build/ in this checkout.  Its samples are held bit-identical to the
port's pure-Python codec (io/flac_py.py) and to the JAX package's readers
(ssr_eval_tpu.io.audio.read_flac, ssr_eval_tpu.io.flac_py) on the same files,
each way round, for mono and stereo, 16-bit and 24-bit, and full-scale noise
(the encoder's VERBATIM escape, tests/test_native_io.py's signal).  The
engine's native batch path gives the Python pool's metrics exactly, on FLAC,
WAV and mixed sets, and `engine.stats.decoders` names the path that ran.
"""

import os
from pathlib import Path

import numpy as np
import pytest

from ssr_eval_tpu.io import audio as j_audio
from ssr_eval_tpu.io import flac_py as j_flac_py
from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.fixtures import ensure_synthetic_vctk, speechlike
from ssr_eval_tpu_torch.harness.helper import SSR_Eval_Helper
from ssr_eval_tpu_torch.harness.testee import BatchedTestee
from ssr_eval_tpu_torch import _native_build
from ssr_eval_tpu_torch.io import audio, flac_native, flac_py
from ssr_eval_tpu_torch.io.audio import write_wav

ROOT = Path(__file__).resolve().parents[1]


def _signal(kind):
    """-> (float32 data [n] or [n, 2], sr, bps) for a case id."""
    if kind == "noise":  # full-scale noise: the encoder's VERBATIM escape
        return np.random.default_rng(6).uniform(-1, 1, 5000).astype(np.float32), 16000, 16
    ch, bps = kind.split("-")
    n = 9000 if ch == "stereo" else 12345
    rng = np.random.default_rng(n)
    t = np.arange(n) / 48000.0
    x = (0.5 * np.sin(2 * np.pi * 440 * t) + 0.02 * rng.standard_normal(n)).astype(np.float32)
    if ch == "stereo":
        x = np.stack([x, -0.5 * x], axis=1)
    return x, 48000, int(bps)


SIGNALS = ["mono-16", "stereo-16", "mono-24", "stereo-24", "noise"]


@pytest.mark.parametrize("kind", SIGNALS)
def test_native_decoders_match_flac_py_and_the_jax_readers(kind, tmp_path):
    x, sr, bps = _signal(kind)
    p = str(tmp_path / "a.flac")
    flac_native.encode(p, x, sr, bps=bps)
    want, want_sr = flac_py.decode_flac(p)
    raw, _, raw_bps = flac_py.decode_flac(p, raw=True)
    assert (want_sr, raw_bps) == (sr, bps)
    q = float(1 << (bps - 1))
    assert np.array_equal(want, np.clip(np.round(x * q), -q, q - 1).astype(np.float32) / np.float32(q))
    for got, got_sr in (flac_native.decode(p), audio.read_flac(p), audio.decode_audio(p), j_audio.read_flac(p),
                        j_flac_py.decode_flac(p)):
        assert got_sr == sr and got.dtype == np.float32 and np.array_equal(got, want)
    i16 = flac_native.decode_i16(p)
    assert (i16 is None) == (bps != 16) and (audio.decode_audio_i16(p) is None) == (bps != 16)
    [(batch, batch_sr)] = flac_native.decode_batch([p], n_threads=2)
    assert batch_sr == sr
    if bps == 16:
        assert i16[0].dtype == batch.dtype == np.int16 and i16[1] == sr
        for got in (i16[0], batch, audio.decode_audio_i16(p)[0]):
            assert np.array_equal(got, raw.astype(np.int16))
    else:
        assert batch.dtype == np.float32 and np.array_equal(batch, want)


@pytest.mark.parametrize("kind", SIGNALS)
def test_port_and_jax_encoders_decode_the_same_each_way(kind, tmp_path):
    """Port-native FLAC through the JAX readers and flac_py, and the JAX
    package's (and the port's flac_py) FLAC through the port's native
    reader: the same samples every way."""
    x, sr, bps = _signal(kind)
    files = {}
    for name, enc in (("port_native", flac_native.encode), ("port_py", flac_py.encode_flac),
                      ("jax_py", j_flac_py.encode_flac)):
        files[name] = str(tmp_path / f"{name}.flac")
        enc(files[name], x, sr, bps=bps)
    if bps == 16:
        files["port_write_flac"] = str(tmp_path / "port_write_flac.flac")
        audio.write_flac(files["port_write_flac"], x, sr)
        files["jax_write_flac"] = str(tmp_path / "jax_write_flac.flac")
        j_audio.write_flac(files["jax_write_flac"], x, sr)
    want, _ = flac_py.decode_flac(files["port_py"])
    for name, p in files.items():
        for reader in (flac_native.decode, flac_py.decode_flac, j_flac_py.decode_flac, j_audio.read_flac):
            got, got_sr = reader(p)
            assert got_sr == sr and np.array_equal(got, want), (name, reader)
    # at 16 bits (write_flac's depth) the native encoder compresses tonal
    # audio; the fallback writes VERBATIM
    if bps == 16 and kind != "noise":
        assert os.path.getsize(files["port_native"]) < 0.9 * os.path.getsize(files["port_py"])


@pytest.mark.parametrize("corrupt", ["garbage", "truncated"])
def test_a_corrupt_file_in_a_batch_raises_naming_it(corrupt, tmp_path):
    good = str(tmp_path / "good.flac")
    flac_native.encode(good, _signal("mono-16")[0], 48000)
    bad = str(tmp_path / "bad.flac")
    with open(bad, "wb") as f:
        f.write(b"not a flac stream" if corrupt == "garbage" else Path(good).read_bytes()[:100])
    with pytest.raises(ValueError, match="bad.flac"):
        flac_native.decode_batch([good, bad, good])
    with pytest.raises(ValueError, match="bad.flac"):
        flac_native.decode(bad)


def test_the_library_is_the_ports_own_build():
    lib = _native_build.build(_native_build.CSRC / "ssrio.cpp")
    assert lib.parent == ROOT / "ssr_eval_tpu_torch" / "_build" and lib.name.startswith("ssrio-")
    assert Path(flac_native._lib()._name).resolve() == lib.resolve()
    assert ROOT / "ssr_eval_tpu" not in lib.resolve().parents
    assert audio.flac_codec() == "native" and flac_native.HAS_BATCH and flac_native.HAS_WAV_BATCH


def test_a_failed_build_falls_back_with_a_warning(tmp_path, monkeypatch):
    def broken(src):
        raise RuntimeError(f"g++ failed on {src.name}: stand-in error")

    monkeypatch.setattr(audio, "_native_state", [])
    monkeypatch.setattr(flac_native, "_bound", None)
    monkeypatch.setattr(flac_native, "build", broken)
    with pytest.warns(RuntimeWarning, match="stand-in error"):
        assert audio.flac_codec() == "python"
    p = str(tmp_path / "f.flac")
    x = _signal("mono-16")[0]
    audio.write_flac(p, x, 48000)  # through flac_py: VERBATIM
    got, _ = audio.read_flac(p)
    assert np.array_equal(got, j_flac_py.decode_flac(p)[0])
    eng = EvalEngine(expand_settings(setting_fft={"cutoff_freq": [4000]}, sr=48000), 48000, 48000, 48000,
                     BatchedTestee(), batch_size=1, device="cpu")
    eng.evaluate_files([p])
    assert eng.stats.decoders == {"python_pool"}


def _write_set(root, kind):
    paths = []
    for i in range(5):
        x = speechlike(0.3 + 0.05 * i, 16000, seed=70 + i)
        if kind == "flac" or (kind == "mixed" and i % 2):
            p = os.path.join(root, f"u{i}.flac")
            audio.write_flac(p, x[:, None], 16000)
        else:
            p = os.path.join(root, f"u{i}.wav")
            write_wav(p, x, 16000)
        paths.append(p)
    return paths


@pytest.mark.parametrize("kind", ["flac", "wav", "mixed"])
def test_engine_native_batch_path_equals_the_python_pool(kind, tmp_path, monkeypatch):
    paths = _write_set(str(tmp_path), kind)
    specs = expand_settings(setting_fft={"cutoff_freq": [4000]}, sr=16000)

    def run(flag):
        monkeypatch.setenv("SSR_EVAL_TPU_NATIVE_BATCH", flag)
        eng = EvalEngine(specs, 16000, 16000, 16000, BatchedTestee(), batch_size=2, device="cpu")
        return eng.evaluate_files(paths), eng.stats

    r_native, s_native = run("1")
    r_pool, s_pool = run("0")
    assert s_native.decoders == {"native_batch"} and s_pool.decoders == {"python_pool"}
    assert s_native.summary()["decoders"] == ["native_batch"]
    assert r_native == r_pool and all(r_pool[p] for p in paths)


def test_helper_synthetic_vctk_run_reports_native_batch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root = ensure_synthetic_vctk(str(tmp_path / "vctk_test"), files_per_speaker=1)
    helper = SSR_Eval_Helper(BatchedTestee(), 44100, 44100, test_data_root=root, setting_fft={"cutoff_freq": [12000]},
                             auto_download=False, device="cpu")
    r = helper.evaluate(verbose=False)
    assert helper.engine.stats.decoders == {"native_batch"}
    assert np.isfinite(r["averaged"]["proc_fft_24000_44100"]["lsd"])
