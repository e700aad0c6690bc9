"""`UNetRes(remat=True)` (the JAX package's `nn.remat` over the encoder
and decoder groups, ssr_eval_tpu/models/unet.py:126-132) on the CPU: one
train step of a small UNet generator gives exactly the loss, gradients and
running statistics of remat=False, and the recomputation moves the
BatchNorms' running statistics no second time."""

import numpy as np
import pytest
import torch

from ssr_eval_tpu_torch.models import nvsr
from ssr_eval_tpu_torch.models.train import NVSRTrainer
from ssr_eval_tpu_torch.models.unet import FlaxBatchNorm, UNetRes


def _generator(remat):
    with torch.device("meta"):
        gen = nvsr.Generator("unet")
    gen.analysis_module = UNetRes(channels=1, widths=(8, 16), blocks_per_group=2, remat=remat)
    return nvsr.init_weights(gen, seed=3).train()


def _batch():
    rng = np.random.default_rng(1)
    lr = np.abs(rng.standard_normal((2, 20, 128))).astype(np.float32) + np.float32(1e-3)
    hr = lr + np.float32(0.1) * np.abs(rng.standard_normal(lr.shape)).astype(np.float32)
    return torch.from_numpy(lr), torch.from_numpy(hr)


def _step(remat, monkeypatch=None):
    """loss.backward() of one train-mode forward -> (loss, grads, buffers,
    running-statistics updates counted)."""
    gen = _generator(remat)
    calls = []
    if monkeypatch is not None:
        update = FlaxBatchNorm._update_running
        monkeypatch.setattr(FlaxBatchNorm, "_update_running", lambda self, m, v: (calls.append(self), update(self, m, v)))
    loss = NVSRTrainer.loss(gen, *_batch())
    loss.backward()
    grads = {k: p.grad.clone() for k, p in gen.named_parameters()}
    bufs = {k: b.clone() for k, b in gen.named_buffers()}
    return gen, loss.detach(), grads, bufs, calls


def test_remat_step_is_bit_identical():
    _, loss, grads, bufs, _ = _step(False)
    _, r_loss, r_grads, r_bufs, _ = _step(True)
    assert torch.equal(loss, r_loss)
    assert grads.keys() == r_grads.keys() and all(torch.equal(grads[k], r_grads[k]) for k in grads)
    assert bufs.keys() == r_bufs.keys() and all(torch.equal(bufs[k], r_bufs[k]) for k in bufs)


@pytest.mark.parametrize("remat", [False, True])
def test_running_statistics_move_once(remat, monkeypatch):
    """Each BatchNorm updates its running statistics once per step; with
    remat the recomputation runs every group's BatchNorms again, and the
    guard keeps it from updating them."""
    gen, _, _, _, calls = _step(remat, monkeypatch)
    bns = [m for m in gen.modules() if isinstance(m, FlaxBatchNorm)]
    assert len(calls) == len(bns) and {id(m) for m in calls} == {id(m) for m in bns}
    assert not any(m.recomputing for m in bns)


def test_remat_recomputes_under_the_guard(monkeypatch):
    """Without the guard the recomputation would move the statistics
    again: the BatchNorms of the groups do run a second time, marked as
    recomputing."""
    seen = []
    forward = FlaxBatchNorm.forward
    monkeypatch.setattr(FlaxBatchNorm, "forward", lambda self, x: (seen.append(self.recomputing), forward(self, x))[1])
    gen, *_ = _step(True)
    n_bns = sum(isinstance(m, FlaxBatchNorm) for m in gen.modules())
    in_groups = sum(
        isinstance(m, FlaxBatchNorm)
        for name, g in gen.analysis_module.named_children() if name.startswith(("encoder_block", "decoder_block"))
        for m in g.modules()
    )
    assert seen.count(False) == n_bns and seen.count(True) == in_groups > 0
    # eval mode and no_grad take the plain path
    seen.clear()
    with torch.no_grad():
        gen(_batch()[0])
    assert seen.count(True) == 0
