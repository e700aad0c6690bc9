"""The engine's batch packing on the CPU: a batch holds exactly its rows, so
a bucket's remainder reaches the testee and the scoring with fewer rows than
`batch_size`, and every file scores bit for bit as in a batch of its own.  Held
for a device testee and a host testee, through the native batch decoder and
the thread-pool decoder; and the one measured exception, a short batch's
testee call filled on the card where filling measured cheaper."""

import glob

import numpy as np
import pytest
import torch

from ssr_eval_tpu_torch.degrade.plan import expand_settings
from ssr_eval_tpu_torch.harness.engine import EvalEngine
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.harness.testee import BasicTestee, BatchedTestee
from ssr_eval_tpu_torch.io.audio import write_flac

SR = 16000
BATCH = 3
# Buckets 5120 (four files: a full batch of 3 and a remainder of 1), 10240
# (1) and 12288 (2): 4 batches of 3, 1, 1 and 2 rows.
LENGTHS = [4500, 5000, 4800, 4700, 9000, 12000, 11000]
ROWS = [3, 1, 1, 2]
CUTOFFS = [4000, 6000]
FLOOR = (1e-3 * np.random.default_rng(11).standard_normal(1 << 15)).astype(np.float32)


class RecordingTestee(BatchedTestee):
    """Adds a fixed floor to the valid samples and records each call's rows."""

    def __init__(self):
        self.rows = []

    def infer_batch(self, x, lengths, state=None):
        self.rows.append(int(x.shape[0]))
        ar = torch.arange(x.shape[1])
        mask = (ar[None, :] < lengths[:, None]).to(torch.float32)
        return x + torch.from_numpy(FLOOR)[ar % FLOOR.shape[0]][None, :] * mask, lengths


class RecordingHostTestee(BasicTestee):
    """The same floor through the host bridge, one utterance a call."""

    def __init__(self):
        super().__init__()
        self.calls = 0

    def infer(self, x):
        self.calls += 1
        return x + FLOOR[np.arange(len(x)) % FLOOR.shape[0]]


@pytest.fixture(scope="module")
def paths(tmp_path_factory):
    spk = tmp_path_factory.mktemp("packing") / "p360"
    spk.mkdir()
    for i, n in enumerate(LENGTHS):
        write_flac(str(spk / f"p360_{i:03d}_mic1.flac"), speechlike(n / SR, SR, seed=60 + i)[:n], SR)
    return sorted(glob.glob(str(spk / "*.flac")))


def _engine(testee, batch_size=BATCH):
    specs = expand_settings(setting_fft={"cutoff_freq": CUTOFFS}, sr=SR)
    return EvalEngine(specs, SR, SR, SR, testee, batch_size=batch_size, device="cpu")


def _scored_rows(eng):
    """Wrap the engine's batched scoring (the host bridge's) to record the
    rows of each batch it scores."""
    rows, score = [], eng._score_batch

    def recorded(y, ny, gt, n_gt):
        rows.append((int(y.shape[0]), int(gt.shape[0])))
        return score(y, ny, gt, n_gt)

    eng._score_batch = recorded
    return rows


@pytest.mark.parametrize("native", ["1", "0"])
@pytest.mark.parametrize("kind", ["device", "host"])
def test_a_batch_carries_only_its_rows(paths, monkeypatch, native, kind):
    monkeypatch.setenv("SSR_EVAL_TPU_NATIVE_BATCH", native)
    testee = RecordingTestee() if kind == "device" else RecordingHostTestee()
    eng = _engine(testee)
    scored = _scored_rows(eng)
    got = eng.evaluate_files(paths)
    assert eng.stats.decoders == ({"native_batch"} if native == "1" else {"python_pool"})
    assert eng.stats.counts["decode"] == len(ROWS)
    assert eng.stats.counters["rows_dispatched"] == len(paths)
    if kind == "device":
        # One call a spec a batch, each with the batch's rows alone.
        assert sorted(testee.rows) == sorted(r for r in ROWS for _ in CUTOFFS)
        assert sum(testee.rows) == len(paths) * len(CUTOFFS)
        assert not scored
    else:
        assert testee.calls == len(paths) * len(CUTOFFS)
        assert sorted(scored) == sorted((r, r) for r in ROWS for _ in CUTOFFS)
    # Every file bit for bit as in a batch of its own (on the CPU a row's
    # arithmetic does not depend on its batch's rows).
    for p in paths:
        alone_testee = RecordingTestee() if kind == "device" else RecordingHostTestee()
        alone = _engine(alone_testee, batch_size=1).evaluate_files([p])[p]
        assert len(alone) == len(CUTOFFS) and all(np.isfinite(v) for m in alone.values() for v in m.values())
        assert got[p] == alone, p


def test_each_row_count_is_a_program_of_its_own(paths):
    """The cost record keys each dispatched program by its rows as well as
    its bucket: the 5120 bucket's full batch and its remainder are two."""
    eng = _engine(RecordingTestee())
    eng.evaluate_files(paths)
    keys = sorted(k[3:] for k in eng._cost_args)
    assert keys == [(1, 5120), (1, 10240), (2, 12288), (3, 5120)]
    assert all(eng._cost_calls[k] == 1 for k in eng._cost_args)
    for key, (_, specs) in eng._cost_args.items():
        assert all(shape[0] == key[3] for shape, _ in specs), (key, specs)


@pytest.mark.parametrize("cheaper", [False, True])
def test_a_short_batch_runs_filled_only_where_that_measured_cheaper(monkeypatch, cheaper):
    """On the card a short batch's testee call is measured once per shape,
    at its first call (which runs at its own rows), and later calls of that
    shape run filled to the batch size only where filling measured cheaper;
    the output keeps the batch's rows.  Full batches are never measured."""
    eng = _engine(RecordingTestee(), batch_size=4)
    eng.device = torch.device("cuda")  # read by the rule alone; the tensors stay on the CPU
    measured = []

    def fill_is_cheaper(x, n, state):
        measured.append(tuple(x.shape))
        return cheaper

    monkeypatch.setattr(eng, "_fill_is_cheaper", fill_is_cheaper)
    x = torch.arange(3 * 8, dtype=torch.float32).reshape(3, 8)
    n = torch.tensor([8, 5, 7])
    want_y, want_n = RecordingTestee().infer_batch(x, n)
    for _ in range(3):
        y, ny = eng._infer_rows(x, n, None)
        assert torch.equal(y, want_y) and torch.equal(ny, want_n)
    full = torch.zeros(4, 8), torch.full((4,), 8)
    eng._infer_rows(*full, None)
    assert measured == [(3, 8)]
    assert eng.testee.rows == ([3, 4, 4, 4] if cheaper else [3, 3, 3, 4])
    assert eng.stats.counters.get("testee_rows_filled", 0) == (2 if cheaper else 0)
