"""The engine's and the helper's spans and counters (`engine.stats`,
`utils.profiling.StageTimers`) on the CPU: host-clock seconds, counts and
padding counters always, `ssr:` spans on the profiler's timeline only
while a profiler runs, with the nesting the names say, and the benchmark's
own spans around them unchanged."""

import glob
from collections import Counter

import numpy as np
import pytest
import torch

from benchmark import run as bench_run
from benchmark.harness import trace as bench_trace
from ssr_eval_tpu_torch import SSR_Eval_Helper
from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.testee import BatchedTestee
from ssr_eval_tpu_torch.io.audio import write_flac
from ssr_eval_tpu_torch.utils.profiling import SPAN_PREFIX, StageTimers

SR = 16000
# Batch 2: 4500 and 5000 share the 5120 bucket and fill a batch; 5100 (5120)
# and 9000 (10240) are remainders of one row each.  3 batches, 4 rows.
LENGTHS = [4500, 5000, 5100, 9000]
BATCH = 2
BATCHES = 3
SAMPLES_REAL = sum(LENGTHS)
SAMPLES_SLOTS = 2 * 5120 + 1 * 5120 + 1 * 10240  # rows x bucket
ROWS = len(LENGTHS)
COUNTERS = {"samples_real": SAMPLES_REAL, "samples_slots": SAMPLES_SLOTS, "rows_dispatched": ROWS,
            "dispatch_eager": BATCHES}
CUTOFFS = [4000, 8000]  # two fft specs, one family
SPECS = len(CUTOFFS)
LAYERS = ("decode", "decode.native", "dispatch", "dispatch.prep", "dispatch.target", "dispatch.degrade",
          "dispatch.testee", "dispatch.score", "drain")


@pytest.fixture(scope="module")
def speaker_dir(tmp_path_factory):
    """One speaker's FLAC files of LENGTHS samples at SR."""
    root = tmp_path_factory.mktemp("vctk")
    spk = root / "p360"
    spk.mkdir()
    rng = np.random.default_rng(5)
    for i, n in enumerate(LENGTHS):
        write_flac(str(spk / f"p360_{i:03d}_mic1.flac"), 0.1 * rng.standard_normal(n).astype(np.float32), SR)
    return root


def _paths(root):
    return sorted(glob.glob(str(root / "p360" / "*.flac")))


def _engine(**kw):
    specs = expand_settings(setting_fft={"cutoff_freq": CUTOFFS}, sr=SR)
    return EvalEngine(specs, SR, SR, SR, BatchedTestee(), batch_size=BATCH, device="cpu", **kw)


def _spans(events, prefix=SPAN_PREFIX):
    """[(name without prefix, start, end)] of the CPU user spans."""
    return [(e.name[len(prefix):], e.time_range.start, e.time_range.end) for e in events
            if e.name.startswith(prefix)]


def _count(spans):
    return Counter(name for name, _, _ in spans)


def _inside(spans, child, parent):
    """Every span named `child` lies within some span named `parent`."""
    outer = [(s, e) for n, s, e in spans if n == parent]
    inner = [(s, e) for n, s, e in spans if n == child]
    return bool(inner) and all(any(ps <= s and e <= pe for ps, pe in outer) for s, e in inner)


def test_no_profiler_no_record_function(speaker_dir, monkeypatch):
    """With no profiler running a span enters no record_function, and the
    run still fills seconds, counts and both counters."""

    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler running")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    eng = _engine()
    eng.evaluate_files(_paths(speaker_dir))
    for name in LAYERS:
        assert eng.stats.seconds[name] > 0 and eng.stats.counts[name] > 0, name
    assert eng.stats.counts["decode"] == BATCHES
    assert eng.stats.counts["dispatch.testee"] == BATCHES * SPECS
    assert set(eng.stats.counters) == set(COUNTERS)


@pytest.mark.parametrize("native", ["1", "0"])
def test_padding_counters_are_a_hand_count(speaker_dir, monkeypatch, native):
    """samples_real: the rows' lengths; samples_slots: rows x bucket, every
    batch, full or not; rows_dispatched: the rows, one a file; whichever
    decoder ran."""
    monkeypatch.setenv("SSR_EVAL_TPU_NATIVE_BATCH", native)
    eng = _engine()
    eng.evaluate_files(_paths(speaker_dir))
    assert eng.stats.decoders == ({"native_batch"} if native == "1" else {"python_pool"})
    assert dict(eng.stats.counters) == COUNTERS
    assert eng.stats.counts["decode"] == BATCHES


def test_profiler_sees_every_span_as_counted(speaker_dir):
    """Under a CPU profiler each span is an `ssr:` event, as many as the
    host counts hold (the decode stream's last, empty step is a span but
    not a batch), and each child lies inside its parent."""
    eng = _engine()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.evaluate_files(_paths(speaker_dir))
    spans = _spans(prof.events())
    want = dict(eng.stats.counts)
    want["decode"] += 1
    assert _count(spans) == want
    assert want["dispatch.degrade"] == BATCHES * (1 + SPECS)  # one family's shared STFT, then each spec
    assert want["dispatch.score"] == want["dispatch.testee"] == BATCHES * SPECS
    assert want["dispatch.prep"] == want["dispatch.target"] == want["dispatch"] == BATCHES
    for child in ("dispatch.prep", "dispatch.target", "dispatch.degrade", "dispatch.testee", "dispatch.score"):
        assert _inside(spans, child, "dispatch"), child
    assert _inside(spans, "decode.native", "decode")


def test_helper_job_holds_every_span(speaker_dir, tmp_path, monkeypatch):
    """Through the helper every span of the call nests inside its `job`."""
    monkeypatch.chdir(tmp_path)
    helper = SSR_Eval_Helper(BatchedTestee(), SR, SR, SR, test_data_root=str(speaker_dir),
                             setting_fft={"cutoff_freq": [c // 2 for c in CUTOFFS]}, batch_size=BATCH,
                             device="cpu", auto_download=False)
    helper.evaluate(verbose=False)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        helper.evaluate(verbose=False)
    spans = _spans(prof.events())
    jobs = [(s, e) for n, s, e in spans if n == "job"]
    assert len(jobs) == 1 and _count(spans)["job.evaluate_files"] == 1
    assert all(jobs[0][0] <= s and e <= jobs[0][1] for n, s, e in spans)
    assert _inside(spans, "dispatch", "job.evaluate_files")
    stats = helper.engine.stats
    assert stats.counts["job"] == 2 and stats.seconds["job"] >= stats.seconds["job.evaluate_files"] > 0


def test_summary_groups_children_under_their_stage(speaker_dir):
    eng = _engine()
    eng.evaluate_files(_paths(speaker_dir))
    s = eng.stats.summary()
    assert set(s["stages"]) == {"decode", "dispatch", "drain"}
    assert set(s["stages"]["dispatch"]["children"]) == {"prep", "target", "degrade", "testee", "score"}
    assert s["stages"]["decode"]["children"]["native"]["calls"] == 1
    assert s["stages"]["dispatch"]["calls"] == BATCHES
    assert s["counters"] == COUNTERS
    t = StageTimers()
    with t.stage("a.b"):
        pass
    assert t.summary()["stages"] == {"a": {"children": {"b": {"s": 0.0, "calls": 1}}}}


def test_profile_dir_trace_holds_program_spans(speaker_dir, tmp_path):
    eng = _engine(profile_dir=str(tmp_path / "prof"))
    eng.evaluate_files(_paths(speaker_dir))
    files = glob.glob(str(tmp_path / "prof" / "*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        text = f.read()
    assert '"ssr:dispatch"' in text and '"ssr:dispatch.testee"' in text


def test_benchmark_spans_keep_one_testee_span_per_spec_and_batch(speaker_dir):
    """The benchmark wraps the testee and every `stats.stage` in its own
    `bench:` spans; the program's testee span is `dispatch.testee`, so
    there is still one `bench:testee` a spec and batch."""
    testee = bench_run.SpanTestee(BatchedTestee())
    specs = expand_settings(setting_fft={"cutoff_freq": CUTOFFS}, sr=SR)
    eng = EvalEngine(specs, SR, SR, SR, testee, batch_size=BATCH, device="cpu")
    eng.evaluate_files(_paths(speaker_dir))
    testee.traced = True
    bench_run.add_spans(eng)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.evaluate_files(_paths(speaker_dir))
    events = prof.events()
    bench = _count(_spans(events, bench_trace.SPAN_PREFIX))
    assert bench["testee"] == BATCHES * SPECS and bench["dispatch"] == BATCHES
    assert bench_trace.summarize(events, 1.0).span_count["testee"] == BATCHES * SPECS
    assert _count(_spans(events))["dispatch.testee"] == BATCHES * SPECS
    assert eng.stats.counts["decode"] == 2 * BATCHES


def test_a_span_that_raises_is_still_counted():
    t = StageTimers()
    with pytest.raises(ValueError):
        with t.stage("dispatch"):
            raise ValueError("x")
    assert t.counts["dispatch"] == 1 and t.seconds["dispatch"] >= 0
    t.add("samples_real", 3)
    t.add("samples_real", 4)
    assert t.counters == {"samples_real": 7}
