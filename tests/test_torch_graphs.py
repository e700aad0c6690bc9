"""The engine's fused chain on the CPU: every batch runs eagerly (the CUDA
graphs engage only on a card, `tests/test_torch_cuda.py` holds them to the
eager chain there), the engine decides where graphs engage from what it
observes, and the chain's phase order (every degradation, then every
testee call, then every score) changes no result."""

import contextlib
import gc

import numpy as np
import pytest
import torch

from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.harness.testee import BasicTestee, BatchedTestee
from ssr_eval_tpu_torch.io.audio import write_wav

SR = 44100
SETTINGS = {
    "setting_fft": {"cutoff_freq": [4000, 8000]},
    "setting_subsampling": {"cutoff_freq": [4000]},
    "setting_lowpass_filtering": {"filter": ["butter"], "cutoff_freq": [4000], "filter_order": [6]},
}


class NoisyTestee(BatchedTestee):
    """Adds a fixed floor to the valid samples, so each spec's estimate
    differs from its degraded input."""

    floor = torch.from_numpy((1e-3 * np.random.default_rng(3).standard_normal(1 << 14)).astype(np.float32))

    def infer_batch(self, x, lengths, state=None):
        ar = torch.arange(x.shape[1])
        mask = (ar[None, :] < lengths[:, None]).to(torch.float32)
        return x + self.floor[ar % self.floor.shape[0]][None, :] * mask, lengths


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    """Two files share a bucket (one full batch of 2), one is a remainder."""
    root = tmp_path_factory.mktemp("graphs")
    out = []
    for i, dur in enumerate((0.2, 0.21, 0.4)):
        p = str(root / f"u{i}.wav")
        write_wav(p, speechlike(dur, SR, seed=40 + i), SR)
        out.append(p)
    return out


def _engine(specs, testee=None, **kw):
    return EvalEngine(specs, SR, SR, SR, testee or NoisyTestee(), batch_size=2, device="cpu", **kw)


def test_cpu_batches_run_eagerly(paths):
    eng = _engine(expand_settings(sr=SR, **SETTINGS))
    eng.evaluate_files(paths)
    assert eng.stats.counts["decode"] == 2
    assert dict(eng.stats.counters)["dispatch_eager"] == 2
    assert eng.stats.counters.get("dispatch_graphed", 0) == eng.stats.counters.get("graph_captures", 0) == 0
    assert not eng._graphs and "dispatch.replay" not in eng.stats.counts


@pytest.mark.parametrize(
    "case,engaged",
    [("device testee", True), ("cpu", False), ("host testee", False), ("host_float64", False),
     ("saved audio", False), ("mp3 spec", False), ("forced eager", False)],
)
def test_graphs_engage_from_what_the_engine_observes(case, engaged):
    """Graphs need the card, a device testee scoring on the device, and
    nothing that reads a batch's device buffers after the next batch."""
    settings = dict(SETTINGS, setting_mp3_compression={"low_kbps": [64]}) if case == "mp3 spec" else SETTINGS
    eng = _engine(
        expand_settings(sr=SR, **settings),
        testee=BasicTestee() if case == "host testee" else None,
        metrics_backend="host_float64" if case == "host_float64" else "device",
        save_processed_result=case == "saved audio",
    )
    if case == "forced eager":
        eng._use_graphs = False
    if case != "cpu":
        eng.device = torch.device("cuda")  # read by the decision alone; nothing runs
    assert eng._graphs_engage() is engaged


def test_phase_order_changes_no_result(paths):
    """One engine over fft, subsampling and IIR specs (every degradation,
    then every testee call, then every score) scores each file bit for bit
    as one engine per spec does (degrade, testee, score)."""
    specs = expand_settings(sr=SR, **SETTINGS)
    assert len({s.family for s in specs}) == 3
    together = _engine(specs).evaluate_files(paths)
    for spec in specs:
        alone = _engine([spec]).evaluate_files(paths)
        for p in paths:
            assert alone[p][spec.key] == together[p][spec.key], (p, spec.key)


class _FakeStream:
    def wait_stream(self, other):
        pass


class _FakeCapture:
    """torch.cuda.graph's context: records whether the collector ran."""

    seen = []

    def __init__(self, graph, pool=None, stream=None):
        pass

    def __enter__(self):
        self.seen.append(("enter", gc.isenabled()))

    def __exit__(self, *exc):
        self.seen.append(("exit", gc.isenabled()))


@pytest.mark.parametrize("fails", [False, True])
def test_capture_holds_the_collector_off(monkeypatch, fails):
    """A collection inside a capture can free another engine's graph, which
    ends the capture: the collector is off while the graph captures (not
    during the eager run before it), and on again after, raise or not."""
    monkeypatch.setattr(torch.cuda, "Stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: _FakeStream())
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: None)
    monkeypatch.setattr(torch.cuda, "graph", _FakeCapture)
    _FakeCapture.seen = []
    eng = _engine(expand_settings(sr=SR, **SETTINGS))
    during = []

    def fn():
        during.append(gc.isenabled())
        if fails and len(during) == 2:
            raise RuntimeError("capture failed")
        return torch.zeros(1)

    assert gc.isenabled()
    if fails:
        with pytest.raises(RuntimeError, match="capture failed"):
            eng._capture(fn)
    else:
        eng._capture(fn)
    assert during == [True, False]
    assert _FakeCapture.seen == [("enter", False), ("exit", False)]
    assert gc.isenabled()
