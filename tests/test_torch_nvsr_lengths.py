"""NVSR on a bucketed batch scores each utterance as it scores alone: the
port's testees at the published widths (69 M parameters, seeded random
weights) against the benchmark's plain reference run on each utterance
unpadded, and each padded row against the port's own [1, n_j] run, over
every sample; and the per-row trim.

Tolerances, as a share of max |wave| of the utterance run alone:
- ROW_TOL 1e-5, a padded row against its [1, n_j] run: the two differ only
  by float32 reassociation (other shapes take other conv algorithms); the
  largest measured is 2.0e-6.  A row that saw its bucket's padding, or was
  trimmed about the bucket's length, is off by O(1).
- PLAIN_TOL 2e-5, the port against `benchmark/reference/nvsr_plain.py`:
  float32 reassociation again, with the reference's float64 |STFT| and
  mel on top; the largest measured is 2.9e-6.  TF32 (operands rounded to
  10 mantissa bits) moves the reference by ~1e-3 of max, bf16 more: the
  test runs the reference in TF32 on one utterance and requires it to
  fail this tolerance.
Sizes: 3 utterances of 0.09-0.66 s in one bucket of 32768 samples (75
frames; the UNet's 128 for the longest row, 64 for the others).
"""

import json

import numpy as np
import pytest
import torch

from benchmark.harness import cells
from benchmark.reference import dsp, nvsr_plain
from benchmark.reference import nvsr_unet_fp32 as reference
from benchmark.testees import nvsr_unet_fp32 as bench_testee
from ssr_eval_tpu_torch.harness.fixtures import speechlike
from ssr_eval_tpu_torch.models import nvsr, testees
from ssr_eval_tpu_torch.utils.bucket import bucket_length

ROW_TOL = 1e-5
PLAIN_TOL = 2e-5
LENGTHS = (4000, 12000, 29000)
CONFIG = json.loads((cells.BENCH / "configs" / "nvsr_unet_fp32.json").read_text())


def _rel(got, want):
    return float((got.double() - want.double()).abs().max() / want.double().abs().max())


@pytest.fixture(scope="module")
def batch():
    x = np.zeros((len(LENGTHS), bucket_length(max(LENGTHS))), np.float32)
    for i, n in enumerate(LENGTHS):
        x[i, :n] = speechlike(n / 44100 + 0.01, 44100, seed=40 + i)[:n]
    return x


@pytest.fixture(scope="module")
def full_width(tmp_path_factory):
    """The benchmark's weights for one seed, and the port's testee built
    from them through its checkpoint loaders."""
    inputs = reference.inputs(CONFIG, 2**31 + 99)
    t = bench_testee.build(CONFIG, inputs, "cpu", str(tmp_path_factory.mktemp("nvsr_ckpt")))
    return inputs, t


def test_full_width_batch_matches_the_plain_reference(batch, full_width):
    inputs, t = full_width
    y, ny = t.infer_batch(torch.from_numpy(batch), torch.tensor(LENGTHS))
    assert ny.tolist() == list(LENGTHS) and y.shape[1] >= batch.shape[1]
    plain = reference.build(CONFIG, inputs, "cpu")
    rows = [torch.from_numpy(batch[i : i + 1, :n].astype(np.float64)) for i, n in enumerate(LENGTHS)]
    for i, n in enumerate(LENGTHS):
        want = plain(rows[i], dsp.identity)[0]
        assert _rel(y[i, :n], want) <= PLAIN_TOL, (i, _rel(y[i, :n], want))
        assert not y[i, n:].any()
    control = plain(rows[-1], dsp.tf32)[0]
    assert _rel(control, want) > PLAIN_TOL, _rel(control, want)


@pytest.mark.parametrize("variant", ["NVSRTestee", "NVSRTestee/fold_bn", "NVSRPostProcTestee",
                                     "NVSRPaddingPostProcTestee"])
def test_padded_rows_equal_their_utterance_alone(batch, full_width, variant):
    """The UNet (unfolded and BN-folded), the vocoder (alone in the
    padding ablation) and the low-band splice."""
    name, _, fold = variant.partition("/")
    t = getattr(testees, name)(model_name="dnn", device="cpu", fold_bn=bool(fold))
    t._set_base(full_width[1]._base)
    y, _ = t.infer_batch(torch.from_numpy(batch), torch.tensor(LENGTHS))
    for i, n in enumerate(LENGTHS):
        alone, _ = t.infer_batch(torch.from_numpy(batch[i : i + 1, :n].copy()), torch.tensor([n]))
        assert alone.shape[1] < y.shape[1] or i == len(LENGTHS) - 1
        assert _rel(y[i, :n], alone[0, :n]) <= ROW_TOL, (i, _rel(y[i, :n], alone[0, :n]))
        assert not y[i, n:].any()


def test_trim_is_about_each_rows_own_output():
    """Row j keeps n_j samples from (est_len_j - n_j) // 2 of its own
    output (reference main.py:22-35), zeros after; without est_len every
    row is trimmed about the buffer, as before."""
    est = torch.arange(3 * 900, dtype=torch.float32).reshape(3, 900) + 1
    est_len = torch.tensor([441, 882, 900])
    ref_len = torch.tensor([300, 800, 899])
    got = nvsr.trim_center(est, ref_len, est_len)
    for j in range(3):
        n = int(ref_len[j])
        want = nvsr_plain.trim_center(est[j : j + 1, : int(est_len[j])], n)[0]
        assert torch.equal(got[j, :n], want) and not got[j, n:].any()
    assert torch.equal(nvsr.trim_center(est, ref_len), nvsr.trim_center(est, ref_len, torch.full((3,), 900)))


def test_engine_binds_the_testees_spans_and_counters(tmp_path):
    """The engine hands its tracer to the testee: the model's layers are
    spans inside "dispatch.testee", and the UNet's frames are counted
    (each row's own rounded up to 64, against the bucket's)."""
    from ssr_eval_tpu_torch.degrade.plan import expand_settings
    from ssr_eval_tpu_torch.harness.engine import EvalEngine
    from ssr_eval_tpu_torch.io.audio import write_wav
    from ssr_eval_tpu_torch.models.unet import UNetRes

    base = nvsr.NVSR("dnn")
    with torch.device("meta"):
        base.generator = nvsr.Generator("unet")
    base.generator.analysis_module = UNetRes(channels=1, widths=(4, 8), blocks_per_group=1)
    nvsr.init_weights(base, 1)
    t = testees.NVSRTestee(model_name="dnn", device="cpu")
    t._set_base(base)
    paths = []
    for i, n in enumerate((6000, 33000)):
        paths.append(str(tmp_path / f"u{i}.wav"))
        write_wav(paths[-1], speechlike(n / 44100 + 0.01, 44100, seed=50 + i)[:n], 44100)
    specs = expand_settings(setting_fft={"cutoff_freq": [4000, 8000]}, sr=44100)
    eng = EvalEngine(specs, 44100, 44100, 44100, t, batch_size=2, device="cpu")
    eng.evaluate_files(paths)
    counts = eng.stats.counts
    for name in ("mel", "unet", "vocoder", "trim"):
        assert counts[f"dispatch.testee.{name}"] == counts["dispatch.testee"] == 2 * 2, name
    # one batch per file (different buckets) of its one row, per spec; the
    # UNet's 4 frames-deep levels round to 4
    frames = [n // 441 + 1 for n in (6000, 33000)]
    slots = [1 + bucket_length(n) // 441 for n in (6000, 33000)]
    assert eng.stats.counters["nvsr_frames_real"] == 2 * sum(1 * -(-f // 4) * 4 for f in frames)
    assert eng.stats.counters["nvsr_frames_slots"] == 2 * sum(1 * -(-s // 4) * 4 for s in slots)


@pytest.mark.parametrize("name", ["tfgan", "hifigan"])
def test_vocoder_rows_equal_their_frames_alone(name):
    """Both vocoders, small: row j of a padded batch, given its frames,
    against its frames alone, over every sample."""
    from ssr_eval_tpu_torch.models.vocoder import HiFiGANVocoder, TFGANConfig, Vocoder

    torch.manual_seed(3)
    voc = Vocoder(TFGANConfig(channels=64)) if name == "tfgan" else HiFiGANVocoder(base_channels=32)
    voc = nvsr.init_weights(voc, 4).eval()
    frames = torch.tensor([5, 9, 16])
    mel = torch.rand(3, 16, 128) + 1e-3
    with torch.no_grad():
        y = voc(mel, frames)
        for j, f in enumerate(frames.tolist()):
            alone = voc(mel[j : j + 1, :f])[0]
            assert _rel(y[j, : f * 441], alone) <= ROW_TOL, (j, _rel(y[j, : f * 441], alone))
