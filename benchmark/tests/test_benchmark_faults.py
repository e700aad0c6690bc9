"""The comparison fails its control and the faults the cells can have.

Control: the reference put in the program's place and computed in TF32
(float32 with the resamplers' product operands rounded to 10 mantissa
bits).  Faults, planted under a whole run with the chip's look skipped:
the testee returns its input unchanged; the mean taken over half of each
speaker's files; one answer altered where the engine produces it.  (The
cells run on one chip: no exchange between chips to leave out.)"""

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.harness import compare
from benchmark.reference import dsp
from benchmark.tests.tiny import tiny_cell

CELLS = ["noise_floor.leaderboard_sweep", "noise_floor.quickstart_jobs"]


@pytest.mark.parametrize("name", CELLS)
def test_tf32_control_is_not_correct(name, one_thread, tmp_path):
    cell = tiny_cell(name)
    prep = run.Prepared(None, run.data.make_pcm(cell.config, 3, "cpu"),
                        run.cells.reference_module(cell.config).inputs(cell.config, 3))
    ref = run.reference_scores(cell, prep, "cpu")
    ctl = run.reference_scores(cell, prep, "cpu", torch.float32, dsp.tf32)
    worst, failed, reason = run.judge_all(cell, [run.as_result(ctl, cell.config["speakers"])], ref)
    assert failed == 1, worst
    over = [k for k in compare.NUMBERS if worst[k] > cell.workload["limits"][k]]
    assert {"sispec_db", "ssim"} <= set(over), worst


def _unchanged(self, x, lengths, state=None):
    return x.to(torch.float32), lengths


def _plant(monkeypatch, fault):
    if fault == "testee_returns_its_input":
        from benchmark.testees.noise_floor import NoisyTestee

        monkeypatch.setattr(NoisyTestee, "infer_batch", _unchanged)
    elif fault == "mean_over_half":
        import ssr_eval_tpu_torch.harness.helper as helper

        mean = helper.dict_mean
        monkeypatch.setattr(helper, "dict_mean", lambda rows: mean(rows[: max(1, len(rows) // 2)]))
    elif fault == "answer_altered":
        from ssr_eval_tpu_torch.harness.engine import EvalEngine

        collate = EvalEngine._collate

        def altered(self, results, paths, idxs, spec, marr, *a, **k):
            marr = np.array(marr, dtype=np.float64)
            marr[:, 0] *= 1.001
            return collate(self, results, paths, idxs, spec, marr, *a, **k)

        monkeypatch.setattr(EvalEngine, "_collate", altered)


@pytest.mark.parametrize("fault", ["testee_returns_its_input", "mean_over_half", "answer_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_not_correct(name, fault, monkeypatch, one_thread):
    _plant(monkeypatch, fault)
    line = run.run_cell(name, 11, 0.2, False, device="cpu", cell=tiny_cell(name))
    assert line["correct"] is False and line["failed"] == line["attempted"] >= 1, line["checks"]
