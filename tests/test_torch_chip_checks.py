"""chip_smoke.py's two comparisons of seeded random-weight models, on the
CPU (the card side runs only in chip_smoke.py):

- `sispec_cos` inverts a SiSpec in dB to the |cos| between the estimate
  and the target that the metric encodes (the port's `_sispec` on the
  same vectors), and a near-orthogonal pair that moves the dB by tens
  moves the cosine by no more than the estimate's relative change, and
  `cos_delta` takes the largest change of that cosine over two runs' pairs;
- `pinned_branches` replays recorded relu / leaky-ReLU branches: an
  element that crossed 0 keeps its recorded slope in the forward and the
  backward, and a forward that calls its activations differently raises;
- `cotangent_grads` gives the reference its own loss gradient, and the
  gradient check at CPU against CPU reads 0 for both models.

Also its copies of the repository's bench.py (held against it, whose main is
never called): the float64 pipeline of the sweep phase's oracle check, and
the well-conditioned testee through the port's engine against bench.py's
through the JAX engine.
"""

import math
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench as jax_bench  # noqa: E402
import chip_smoke as cs  # noqa: E402
from ssr_eval_tpu.degrade.plan import expand_settings as j_expand  # noqa: E402
from ssr_eval_tpu_torch.degrade.plan import expand_settings  # noqa: E402
from ssr_eval_tpu_torch.harness.engine import EvalEngine  # noqa: E402
from ssr_eval_tpu_torch.harness.fixtures import speechlike  # noqa: E402
from ssr_eval_tpu_torch.io.audio import write_wav  # noqa: E402
from ssr_eval_tpu_torch.metrics.kernels import _sispec  # noqa: E402
from tests.test_torch_harness import PARITY  # noqa: E402


def _cos(a, b):
    return abs(float((a * b).sum() / (a.norm() * b.norm())))


@pytest.mark.parametrize("tilt", [0.0, 1e-3, 0.3])
def test_sispec_cos_is_the_metrics_cosine(tilt):
    rng = np.random.default_rng(0)
    t = torch.from_numpy(rng.standard_normal((1, 40, 30)))
    n = torch.from_numpy(rng.standard_normal((1, 40, 30)))
    n = n - (n * t).sum() / (t * t).sum() * t  # orthogonal to t
    e = tilt * t + n
    db = float(_sispec(e, t))
    # abs: the metric's EPS inside the log floors the ratio at 1e-12 (cos 1e-6)
    assert cs.sispec_cos(db) == pytest.approx(_cos(e, t), rel=1e-6, abs=2e-6)
    # a 1e-4 relative change of a near-orthogonal estimate
    e2 = e + 1e-4 * e.norm() * t / t.norm()
    d_cos = abs(cs.sispec_cos(float(_sispec(e2, t))) - cs.sispec_cos(db))
    assert d_cos <= 1.01e-4
    if tilt == 0.0:
        assert abs(float(_sispec(e2, t)) - db) > 10.0  # the dB moves by tens


def test_cos_delta_is_the_largest_pair_cosine_change():
    """`cos_delta` over two helper results: the largest per-pair change of
    log-SiSpec's |cos t|, 0 for a run against itself; at -60 dB (cos t =
    1e-3) a 1 dB move is a change of 1.2e-4 in the cosine."""
    def res(dbs):
        return {"p000": {f"f{i}.wav": {"k": {"log_sispec": db}} for i, db in enumerate(dbs)},
                "averaged": {}, "each_speaker": {}}

    a, b = res([-60.0, -10.0]), res([-59.0, -10.0 + 1e-3])
    assert cs.cos_delta(a, a) == 0.0
    near_orthogonal = abs(cs.sispec_cos(-60.0) - cs.sispec_cos(-59.0))
    assert abs(cs.sispec_cos(-10.0) - cs.sispec_cos(-10.0 + 1e-3)) < near_orthogonal
    assert cs.cos_delta(a, b) == near_orthogonal == pytest.approx(1.22e-4, rel=1e-2)


def test_pinned_branches_replay_the_recorded_branches():
    x = torch.tensor([-1.0, -1e-7, 2.0])
    masks = []
    with cs.pinned_branches(masks, record=True):
        assert torch.equal(F.leaky_relu(x, 0.1), torch.tensor([-0.1, -1e-8, 2.0]))
        assert torch.equal(F.relu(x), torch.tensor([0.0, 0.0, 2.0]))
    y = torch.tensor([-1.0, 1e-7, 2.0], requires_grad=True)  # element 1 crossed 0
    with cs.pinned_branches(masks, record=False):
        out = F.leaky_relu(y, 0.1)
        F.relu(y).sum().backward(retain_graph=True)
    assert y.grad.tolist() == [0.0, 0.0, 1.0]
    (g,) = torch.autograd.grad(out.sum(), y)
    assert g.tolist() == pytest.approx([0.1, 0.1, 1.0])
    assert F.relu is torch.nn.functional.relu and F.relu(torch.tensor([-1.0])).item() == 0.0  # restored
    with pytest.raises(AssertionError, match="differently"):
        with cs.pinned_branches(masks, record=False):
            F.relu(torch.zeros(4))
    with pytest.raises(AssertionError, match="fewer"):
        with cs.pinned_branches(masks, record=False):
            F.leaky_relu(y, 0.1)


@pytest.mark.parametrize("kind", ["generator", "vocoder"])
def test_cotangent_grads_give_the_loss_gradient(kind):
    ref = cs.gradient_case(kind, "cpu", 3)
    plain = cs.gradient_case(kind, "cpu", 3)
    plain[2]().backward()
    want = cs._grads_of(plain[0])
    got, other = cs.cotangent_grads(ref, cs.gradient_case(kind, "cpu", 3))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(other[k], want[k]), k
    assert cs._leaf_delta(got, other, cs.TRAIN_GRAD_FLOOR) == (0.0, None)
    with torch.no_grad():
        assert math.isfinite(float(ref[2]()))


@pytest.fixture(scope="module")
def utts(tmp_path_factory):
    """Two 2 s speech-like utterances at the sweep's rate, seeds 1000 + i
    as in the sweep phase and bench.py."""
    d = tmp_path_factory.mktemp("utts")
    paths = [str(d / f"utt_{i:03d}.wav") for i in range(2)]
    for i, p in enumerate(paths):
        write_wav(p, speechlike(2.0, cs.SR, seed=1000 + i), cs.SR)
    return paths


@pytest.mark.parametrize("noisy", [False, True])
def test_f64_pipeline_equals_bench_pys(utts, noisy):
    noise = cs.make_noise() if noisy else None
    assert cs.CUTOFFS == jax_bench.CUTOFFS and cs.SR == jax_bench.SR
    got = cs.f64_pipeline_one(utts[0], cs.CUTOFFS, noise)
    want = jax_bench._f64_pipeline_one(utts[0], jax_bench.CUTOFFS, noise)
    assert list(got) == list(want) and len(got) == 7
    assert got == want


def test_noisy_testee_matches_bench_pys(utts):
    """bench.py's _make_noisy_testee through the JAX engine and chip_smoke's
    noisy testee through the port's, on two utterances: per pair within
    tests/test_torch_harness.py's PARITY."""
    cutoffs = [4000, 16000]
    testee, noise = cs.noisy_testee(torch.device("cpu"))
    want = jax_bench._engine(j_expand(setting_fft={"cutoff_freq": cutoffs}, sr=cs.SR),
                             jax_bench._make_noisy_testee(noise), batch=2).evaluate_files(utts)
    got = EvalEngine(expand_settings(setting_fft={"cutoff_freq": cutoffs}, sr=cs.SR), cs.SR, cs.SR, cs.SR, testee,
                     batch_size=2, device="cpu").evaluate_files(utts)
    n = 0
    for p in utts:
        assert list(got[p]) == list(want[p])
        for key, m in want[p].items():
            for k in cs.METRICS:
                assert abs(got[p][key][k] - m[k]) <= PARITY[k], (p, key, k, got[p][key][k], m[k])
            n += 1
    assert n == 2 * len(cutoffs)
