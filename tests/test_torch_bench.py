"""The port's benchmark program (ssr_eval_tpu_torch/bench.py) against the
repository's bench.py on the CPU: the float64 oracle copy, the float64
pipeline, the dataset writer, the sizes and the well-conditioned testee
through both engines; a quick run of its main on the CPU (last line,
detail file, nothing written beside the repository's bench files); its
NVSR section with a small model; and its refusal to run without a card
unless the CPU is asked for.  bench.py's main is never called."""

import contextlib
import hashlib
import importlib.util
import io
import json
import math
import os

import numpy as np
import pytest
import torch

import bench as jax_bench
from ssr_eval_tpu.degrade.plan import expand_settings as j_expand
from ssr_eval_tpu_torch import bench
from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.io.audio import read_wav_i16
from ssr_eval_tpu_torch.metrics import host_reference
from ssr_eval_tpu_torch.models import testees
from tests import oracles
from tests.test_torch_harness import PARITY
from tests.test_torch_nvsr import _small_nvsr

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GUARDED = ("BENCH_DETAIL.json", "BASELINE_F64.json")  # the JAX bench's own files
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "detail", "detail_file"}
METRICS = ("lsd", "log_sispec", "sispec", "ssim")
CPU = torch.device("cpu")


def _digests():
    out = {}
    for name in GUARDED:
        with open(os.path.join(ROOT, name), "rb") as f:
            out[name] = hashlib.sha256(f.read()).hexdigest()
    return out


def _specs(cutoffs, expand=expand_settings):
    return expand(setting_fft={"cutoff_freq": [2 * c for c in cutoffs]}, sr=bench.SR)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one intra-op thread: the file runs the engine
    many times (the quick run's passes and its 12-call drain split), and
    under the suite's parallel workers each op's thread team waits on the
    others' (20x slower with the default team of one thread per core)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def utts(tmp_path_factory):
    """Four utterances at the quick length, written by the module."""
    d = tmp_path_factory.mktemp("utts")
    return bench.make_dataset(str(d), 4, bench.QUICK.utt_seconds)


@pytest.mark.parametrize("n_fft,hop", [(2048, 441), (2229, 480), (743, 160)])
def test_oracle_copy_equals_the_test_oracle(n_fft, hop):
    rng = np.random.default_rng(n_fft)
    x = rng.standard_normal(9000)
    y = x + 0.1 * rng.standard_normal(9000)
    Z = host_reference.stft_np(x, n_fft, hop)
    np.testing.assert_array_equal(Z, oracles.stft_np(x, n_fft, hop))
    for length in (len(x), None):
        np.testing.assert_array_equal(host_reference.istft_np(Z, n_fft, hop, length=length),
                                      oracles.istft_np(Z, n_fft, hop, length=length))
    est, tgt = np.abs(host_reference.stft_np(y, n_fft, hop)).T, np.abs(Z).T
    for name in ("lsd_np", "sispec_np", "ssim_np"):
        assert getattr(host_reference, name)(est, tgt) == getattr(oracles, name)(est, tgt), name
    log_e, log_t = np.log10(est + 1e-12), np.log10(tgt + 1e-12)
    assert host_reference.sispec_np(log_e, log_t) == oracles.sispec_np(log_e, log_t)


@pytest.mark.parametrize("noisy", [False, True])
def test_f64_pipeline_equals_bench_pys(utts, noisy):
    noise = bench.make_noise() if noisy else None
    assert list(bench.FULL.cutoffs) == jax_bench.CUTOFFS
    got = bench.f64_pipeline_one(utts[0], bench.FULL.cutoffs, noise)
    want = jax_bench._f64_pipeline_one(utts[0], jax_bench.CUTOFFS, noise)
    assert list(got) == list(want) and len(got) == 7
    assert got == want


def test_dataset_equals_bench_pys(tmp_path, monkeypatch):
    monkeypatch.setattr(jax_bench, "UTT_SECONDS", bench.QUICK.utt_seconds)
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = jax_bench._make_dataset(str(tmp_path / "jax"), 2)
    got = bench.make_dataset(str(tmp_path / "port"), 2, bench.QUICK.utt_seconds)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    for g, w in zip(got, want):
        (xg, srg), (xw, srw) = read_wav_i16(g), read_wav_i16(w)
        assert srg == srw == bench.SR and len(xg) == int(bench.QUICK.utt_seconds * bench.SR)
        np.testing.assert_array_equal(xg, xw)


@pytest.mark.parametrize("quick", [False, True])
def test_sizes_are_bench_pys(quick, monkeypatch):
    """The module's sizes against bench.py's, loaded afresh (its sizes are
    read from SSR_BENCH_QUICK when it is imported)."""
    if quick:
        monkeypatch.setenv("SSR_BENCH_QUICK", "1")
    else:
        monkeypatch.delenv("SSR_BENCH_QUICK", raising=False)
    spec = importlib.util.spec_from_file_location("bench_sizes", os.path.join(ROOT, "bench.py"))
    m = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(m)
    sz = bench.QUICK if quick else bench.FULL
    assert (sz.n_utts, sz.utt_seconds, sz.batch, sz.passes, sz.n_base, list(sz.cutoffs)) == (
        m.N_UTTS, m.UTT_SECONDS, m.BATCH, m.PASSES, m.N_BASE, m.CUTOFFS
    )
    assert bench.SR == m.SR
    # the kernel A/B's shape: bench.py's [8, 266240] with 604 frames
    assert (bench.AB_ROWS, bench.AB_LEN) == (8, 266240)
    assert 1 + (bench.AB_LEN + 2 * (bench.AB_NFFT // 2) - bench.AB_NFFT) // bench.AB_HOP == 604


def test_noisy_testee_matches_bench_pys(utts):
    """bench.py's _make_noisy_testee through the JAX engine and the port's
    NoisyTestee through the port's, on two utterances: per pair within
    tests/test_torch_harness.py's PARITY."""
    noise = bench.make_noise()
    cutoffs = bench.QUICK.cutoffs
    want = jax_bench._engine(_specs(cutoffs, j_expand), jax_bench._make_noisy_testee(noise), batch=2).evaluate_files(
        utts[:2]
    )
    got = bench.engine(_specs(cutoffs), bench.NoisyTestee(noise), 2, CPU).evaluate_files(utts[:2])
    n = 0
    for p in utts[:2]:
        assert list(got[p]) == list(want[p])
        for key, m in want[p].items():
            for k in METRICS:
                assert abs(got[p][key][k] - m[k]) <= PARITY[k], (p, key, k, got[p][key][k], m[k])
            n += 1
    assert n == 2 * len(cutoffs)


@pytest.fixture(scope="module")
def quick_run(tmp_path_factory):
    """main() on the CPU in quick mode without NVSR, from a scratch cwd."""
    cwd = tmp_path_factory.mktemp("cwd")
    detail = tmp_path_factory.mktemp("out") / "detail.json"
    before = _digests()
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(out):
        mp.setenv("SSR_BENCH_QUICK", "1")
        mp.setenv("SSR_BENCH_CPU", "1")
        mp.setenv("SSR_BENCH_NVSR", "0")
        mp.chdir(cwd)
        rc = bench.main(["--detail", str(detail)])
    return {"rc": rc, "stdout": out.getvalue(), "detail": detail, "cwd": cwd, "before": before, "after": _digests()}


def test_quick_run_prints_bench_pys_line_under_2kb(quick_run):
    assert quick_run["rc"] == 0
    last = quick_run["stdout"].strip().splitlines()[-1]
    line = json.loads(last)
    assert set(line) == LINE_KEYS and len(last.encode()) < 2048
    assert line["metric"] == "utterances/sec/chip (VCTK fft-sweep eval)" and line["unit"] == "utt/s/chip"
    assert line["value"] > 0 and line["vs_baseline"] > 0
    assert line["detail_file"] == str(quick_run["detail"])
    assert line["detail"]["backend"] == "cpu" and line["detail"]["n_chips"] == 1 and line["detail"]["card"] is None


def test_quick_run_writes_its_detail_only_where_asked(quick_run):
    assert quick_run["detail"].exists()
    assert os.listdir(quick_run["cwd"]) == []  # no bench_torch_detail.json, no results/
    assert quick_run["after"] == quick_run["before"]


def test_quick_run_sections(quick_run):
    with open(quick_run["detail"]) as f:
        d = json.load(f)
    assert d["max_abs_delta_wellconditioned"]["lsd"] <= 1e-3
    assert d["max_abs_delta_device_vs_host_float64"]["lsd"] <= 1e-3
    assert set(d["per_key_delta_wellconditioned"]) == set(d["per_key_dLSD_identity_floor_dominated"]) == {
        s.key for s in _specs(bench.QUICK.cutoffs)
    }
    assert d["nvsr"] == {"skipped": "SSR_BENCH_NVSR=0"}
    assert "skipped" in d["kernel_ab"]
    assert "error" not in d["mp3"] and "error" not in d["iir_subsampling_matrix"]
    assert d["headline_stft_launches"] == 0  # the CPU runs the plain version
    assert d["headline_batches_per_pass"] == 2 and len(d["pass_times_s"]) == bench.QUICK.passes
    stage_sum, elapsed = d["stage_sum_vs_elapsed_s"]
    assert 0 < stage_sum <= elapsed * 1.05
    split = d["headline_drain_split"]
    assert split["k"] == bench.QUICK.drain_k and split["one_call_ms"] > 0
    assert split["roofline_ideal_ms_per_call"] is None  # the CPU has no peaks
    assert d["headline_utilization"]["flops_per_utt"] > 0 and "mfu_vs_fp32_peak" not in d["headline_utilization"]
    assert d["baseline_utt_per_s"] > 0 and d["baseline_host"]["cpu"]


def test_nvsr_section_with_a_small_model(utts, monkeypatch):
    """The section's testee class built with a small UNet (the full-width
    model is a card's work)."""
    base = _small_nvsr("unet", seed=1)
    full = testees.NVSRTestee
    built = []

    def small(model_name, dtype, device):
        assert (model_name, device) == ("unet", CPU)
        t = full(model_name="dnn", dtype=dtype, device=device)
        t._set_base(base)
        built.append(dtype)
        return t

    monkeypatch.setattr(testees, "NVSRTestee", small)
    sz = bench.QUICK._replace(n_nvsr=2)
    specs = _specs(bench.QUICK.cutoffs[:1])
    d = bench.nvsr_section(specs, utts, CPU, sz, {"device_kind": "cpu"})
    assert built == [torch.bfloat16, None]
    assert d["utt_per_s_per_chip_bf16"] > 0 and d["utt_per_s_per_chip_f32"] > 0
    assert list(d["lsd_per_cutoff"]) == [specs[0].key] and all(math.isfinite(v) for v in d["lsd_per_cutoff"].values())
    assert 0 <= d["max_abs_dLSD_bf16_vs_f32"] < 0.5  # tests/test_models.py's bf16 bound
    assert d["stft_launches_bf16"] == d["stft_launches_f32"] == 0
    assert d["utilization_bf16"]["drain_split"]["k"] == sz.drain_k
    assert d["utilization_f32"]["flops_per_utt"] > 0 and "drain_split" not in d["utilization_f32"]


def test_main_needs_a_card_unless_the_cpu_is_asked(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SSR_BENCH_CPU", raising=False)
    monkeypatch.chdir(tmp_path)
    assert bench.main(["--detail", str(tmp_path / "detail.json")]) != 0
    assert os.listdir(tmp_path) == []
    assert "needs a CUDA card" in capsys.readouterr().err
