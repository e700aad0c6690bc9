"""Work counts at known shapes, and the trace arithmetic."""

import math

import pytest

from benchmark.harness import cells, data, trace, work
from benchmark.metrics import _common


def test_fft_and_stft_counts():
    assert work.fft_flops(2048) == 2.5 * 2048 * 11
    c = work.stft_call(44100, 2048, 441)
    frames, bins = 1 + 44100 // 441, 1025
    assert c["flop"] == frames * (2.5 * 2048 * 11 + 3 * bins)
    assert c["bytes"] == 4.0 * (44100 + 2048 + frames * bins)
    assert work.least_seconds(c) == max(c["flop"] / 67e12, c["bytes"] / 3.35e12)


def test_resample_counts():
    assert work.resampled_length(48000, 48000, 44100) == 44100
    assert work.resampled_length(44101, 44100, 48000) == math.ceil(44101 * 160 / 147)
    assert work.resample_flops(44100, 48000, 44100) == pytest.approx(2 * 44100 * 3201 / 147)
    assert work.resample_flops(1000, 44100, 44100) == 0.0


def test_job_work_one_file():
    helper = {"input_sr": 44100, "output_sr": 44100, "evaluation_sr": 44100,
              "setting_fft": {"cutoff_freq": [1000, 2000]}}
    w = work.job_work([48000], 48000, helper, {"testee_flop_per_sample": 1}, cells.degradations(helper))
    n = 44100
    d_frames = m_frames = 1 + n // 441
    target = work.stft_call(n, 2048, 441)
    want = 2 * work.resample_flops(n, 48000, 44100) + 3 * d_frames * work.fft_flops(2048)
    want += 2 * n + 3 * target["flop"] + 2 * m_frames * 1025 * work.METRIC_FLOP_PER_BIN
    assert w["flop"] == pytest.approx(want)
    assert w["stft_least_s"] == pytest.approx(3 * work.least_seconds(target))


def test_union_and_gaps():
    iv = [(0.0, 10.0), (5.0, 20.0), (30.0, 40.0)]
    assert trace.union_seconds(iv) == pytest.approx(30e-6)
    assert trace.idle_gaps(iv, 0.0, 50.0) == [(20.0, 10.0), (40.0, 10.0)]


def test_fft_family_keys_and_flop():
    fft = cells.degrade_module("fft")
    assert fft.spec_keys({"cutoff_freq": [1000, 22050]}, 44100) == ["proc_fft_2000_44100", "proc_fft_44099_44100"]
    assert fft.flop(44100, {"cutoff_freq": [1000, 2000]}, 44100) == 3 * 101 * work.fft_flops(2048)


def test_first_files_of_every_speaker_spread_over_the_grid():
    """evaluate(limit_test_nums=2) reads each speaker's first two names: the
    16 lengths sample the whole grid, and every speaker holds every length."""
    cfg = cells.load_cell("noise_floor.quickstart_jobs").config
    grid = cfg["durations_s"]
    plan = data.file_plan(cfg)
    per = {}
    for spk, name, n in plan:
        per.setdefault(spk, []).append((name, n / cfg["native_sr"]))
    for files in per.values():
        assert sorted(d for _, d in files) == pytest.approx(sorted(grid))
    first = [d for files in per.values() for _, d in sorted(files)[:2]]
    assert min(first) == min(grid) and max(first) == max(grid)
    assert sum(first) / len(first) == pytest.approx(sum(grid) / len(grid), rel=0.02)
    assert data.length_stride(48, 8) == 29


def test_idle_share_divides_traced_busy_by_untraced_wall():
    Job = type("Job", (), {})

    def job(wall, traced):
        j = Job()
        j.wall_s, j.traced = wall, traced
        return j

    jobs = [job(1.0, False), job(1.2, False), job(1.9, True), job(2.1, True)]
    tr = trace.Summary(busy_s=0.88, window_s=4.0, by_name={}, span_device_s={}, span_count={}, gaps=[])
    ctx = type("Ctx", (), {"jobs": jobs, "trace": tr})()
    assert _common.idle_share(ctx) == pytest.approx(100 * (1 - 0.44 / 1.1))
    ctx.jobs = jobs[2:]
    assert _common.idle_share(ctx) is None


def test_testee_stft_counts_each_call_per_spec_on_the_input_signal():
    """A configuration's `testee_stft` adds its calls, once a spec, over
    the input-rate samples; without the key the count is as before."""
    helper = {"input_sr": 44100, "output_sr": 44100, "evaluation_sr": 44100,
              "setting_fft": {"cutoff_freq": [1000, 2000, 4000]}}
    families = cells.degradations(helper)
    base = work.job_work([48000, 96000], 48000, helper, {"testee_flop_per_sample": 1}, families)
    calls = [{"n_fft": 2048, "hop": 441}, {"n_fft": 1024, "hop": 256}]
    got = work.job_work([48000, 96000], 48000, helper, {"testee_flop_per_sample": 1, "testee_stft": calls}, families)
    extra = sum(3 * work.least_seconds(work.stft_call(n, c["n_fft"], c["hop"])) for n in (44100, 88200) for c in calls)
    assert got["flop"] == base["flop"]
    assert got["stft_least_s"] == pytest.approx(base["stft_least_s"] + extra, rel=1e-12)
    noise_floor = cells.load_cell("noise_floor.leaderboard_sweep").config
    assert "testee_stft" not in noise_floor
