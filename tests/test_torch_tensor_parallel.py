"""The trainer's tensor parallelism (`models/tensor_parallel.py`,
`make_mesh(tp=...)`) against the JAX rule and the one-process step, on the
CPU with gloo.

- The set of sharded weights of the full-width unet and the dnn generator
  equals the JAX `param_sharding` rule's on a (4 data x 2 model) mesh of the
  test session's virtual CPU devices, mapped through the port's converter
  (shapes only: jax.eval_shape, zero-stride placeholders, the meta device).
- Real multi-process runs (subprocesses running this file's `__main__`
  block, `python -m tests.test_torch_tensor_parallel ...`): a small UNet
  generator whose 64-channel layers are sharded takes one step at tp = 2
  on 2 processes, and at dp 2 x tp 2 on 4 processes.  The loss, every
  gradient leaf and every parameter after the update (gathered to full
  shapes), and the BatchNorm running statistics are within DP_TOL, with
  tests/test_torch_parallel.py's scales (`_dp_violations`), of the step
  with nothing sharded on the same data split: the one-process step at
  tp = 2, the 2-process data-parallel step at dp 2 x tp 2.  At dp 2 x tp 2
  each leaf is also no further from the one-process step than the
  data-parallel step is, plus DP_TOL.  A variant whose sharded layers take
  their input without the backward all-reduce fails that check; rank 0's
  checkpoint has the plain trainer's names and shapes.
Every subprocess gets communicate(timeout=240), init_process_group a 60 s
timeout and one thread.
"""

import os
import socket
import subprocess
import sys
from datetime import timedelta

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests.test_torch_parallel import DP_TOL, _dp_gaps, _dp_violations, global_batch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# A 64-channel level, so the rule shards something at tp = 2.  Splitting
# the batch over data ranks rounds the BatchNorm moments and the gradient
# sums differently from one process, and on some seeded random weights
# that alone moves a gradient past DP_TOL (dp 2, tp 1, nothing sharded).
# So a run with data ranks is held to the data-parallel step on the same
# split, and a failure points at the sharding.
TP_UNET = dict(widths=(8, 64), blocks_per_group=1)


# ----------------------------------------------------------------------
# Subprocess side
# ----------------------------------------------------------------------


def tp_unet_trainer(mesh=None):
    """NVSRTrainer with the small UNet generator, seeded weights."""
    from ssr_eval_tpu_torch.models import nvsr
    from ssr_eval_tpu_torch.models.train import NVSRTrainer
    from ssr_eval_tpu_torch.models.unet import UNetRes

    tr = NVSRTrainer(model_name="dnn", mesh=mesh, device=None if mesh is not None else "cpu")
    with torch.device("meta"):
        gen = nvsr.Generator("unet")
    gen.analysis_module = UNetRes(channels=1, **TP_UNET)
    tr.model.generator = gen
    return tr, tr.init_state(seed=5)


def _full(gen, name, t):
    """A sharded parameter's tensor (or gradient) gathered to full shape."""
    import torch.distributed as dist

    from ssr_eval_tpu_torch.models import tensor_parallel as tpm

    mod = gen.get_submodule(name.rsplit(".", 1)[0]) if "." in name else gen
    if not (isinstance(mod, tpm._ColumnSharded) and name.endswith(".weight")):
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(mod.tp_group))]
    dist.all_gather(parts, t.contiguous(), group=mod.tp_group)
    return torch.cat(parts, tpm.output_axis(mod))


def tp_step_record(tr, state):
    """One step on the global batch -> {name: array} in full shapes: the
    loss, every gradient, every parameter after the update, every
    BatchNorm buffer."""
    state, loss = tr.step(state, *global_batch())
    gen = state["model"]
    out = {"loss": loss.numpy().reshape(1)}
    for k, p in gen.named_parameters():
        out[f"grad/{k}"] = _full(gen, k, p.grad).numpy()
        out[f"param/{k}"] = _full(gen, k, p.detach()).numpy()
    for k, b in gen.named_buffers():
        if "running" in k:
            out[f"stats/{k}"] = b.numpy()
    return out


def _rank_tp(rank, tp, out_npz, ckpt):
    """The TP step, its checkpoint, then the step with the sharded layers'
    backward all-reduce taken out."""
    from ssr_eval_tpu_torch.models import tensor_parallel as tpm
    from ssr_eval_tpu_torch.models.train import make_mesh

    tr, state = tp_unet_trainer(make_mesh(tp=int(tp), device="cpu"))
    sharded = [k for k, m in state["model"].named_modules() if isinstance(m, tpm._ColumnSharded)]
    synced = tp_step_record(tr, state)
    written = tr.save(ckpt, state)
    assert (written is not None) == (rank == 0), written

    class NoAllReduce:
        apply = staticmethod(lambda x, group: x)

    tpm._CopyToModel = NoAllReduce
    partial = tp_step_record(*tp_unet_trainer(make_mesh(tp=int(tp), device="cpu")))
    np.savez(out_npz, n_sharded=np.array(len(sharded)), **{f"synced/{k}": v for k, v in synced.items()},
             **{f"partial/{k}": v for k, v in partial.items()})


def main(mode, address, world, rank, *args):
    from ssr_eval_tpu_torch.parallel.multihost import init_distributed

    rank = int(rank)
    torch.set_num_threads(1)
    init_distributed(address, int(world), rank, device="cpu", timeout=timedelta(seconds=60))
    try:
        {"tp": _rank_tp}[mode](rank, *args)
    finally:
        torch.distributed.destroy_process_group()
    print(f"[rank {rank}] ok", flush=True)


# ----------------------------------------------------------------------
# Test side
# ----------------------------------------------------------------------


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run(mode, per_rank_args):
    address = f"localhost:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    world = str(len(per_rank_args))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_tensor_parallel", mode, address, world, str(r), *map(str, a)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for r, a in enumerate(per_rank_args)
    ]
    try:
        logs = [p.communicate(timeout=240)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} failed:\n{log[-4000:]}"


@pytest.mark.parametrize("model_name", ["unet", "dnn"])
def test_sharded_weights_follow_the_jax_rule(model_name):
    from ssr_eval_tpu.models import nvsr as j_nvsr
    from ssr_eval_tpu.models.train import make_mesh as j_make_mesh, param_sharding

    from ssr_eval_tpu_torch.models import convert, nvsr
    from ssr_eval_tpu_torch.models.tensor_parallel import sharded_weight_names

    mesh = j_make_mesh(8, tp=2)
    shapes = jax.eval_shape(
        lambda: j_nvsr.NVSR(model_name=model_name).init(jax.random.PRNGKey(0), jnp.ones((2, 64, 128)), train=True)
    )

    def mark(t):
        if hasattr(t, "items"):
            return {k: mark(v) for k, v in t.items()}
        on = "model" in tuple(param_sharding(None, t, mesh).spec)
        return np.broadcast_to(np.float32(on), t.shape)

    arrays = convert.flax_to_port_arrays({"params": mark(shapes["params"])})
    want = {k for k, v in arrays.items() if v.size and v.flat[0] == 1.0}
    with torch.device("meta"):
        gen = nvsr.Generator(model_name)
    got = {f"generator.{k}" for k in sharded_weight_names(gen, 2)}
    assert want and got == want, (sorted(got ^ want))
    # every sharded entry is a weight, and a ConvTranspose2d's is sharded on dim 1
    assert all(k.endswith(".weight") for k in got)
    if model_name == "unet":
        assert "generator.analysis_module.decoder_block1.conv1.weight" in got


@pytest.mark.parametrize("world,tp", [(2, 2), (4, 2)], ids=["tp2", "dp2xtp2"])
def test_tp_step_equals_one_process_step(world, tp, tmp_path):
    outs = [tmp_path / f"rank{r}.npz" for r in range(world)]
    ckpt = tmp_path / "tp_ckpt"
    _run("tp", [(tp, o, ckpt) for o in outs])
    tr, state = tp_unet_trainer()
    want = one = tp_step_record(tr, state)
    zs = [np.load(o) for o in outs]
    assert int(zs[0]["n_sharded"]) > 0
    for z in zs[1:]:  # the ranks agree bit for bit
        for k in want:
            assert np.array_equal(zs[0][f"synced/{k}"], z[f"synced/{k}"]), k
    got = {k: zs[0][f"synced/{k}"] for k in want}
    if world > tp:  # data ranks: the same split with nothing sharded
        dp_outs = [tmp_path / f"dp_rank{r}.npz" for r in range(world // tp)]
        _run("tp", [(1, o, tmp_path / "dp_ckpt") for o in dp_outs])
        dp = np.load(dp_outs[0])
        want = {k: dp[f"synced/{k}"] for k in one}
        # against the one-process step: no further than the data split
        # alone, plus DP_TOL, leaf by leaf
        dp_gap = _dp_gaps(want, one, tr.learning_rate)
        worse = {k: (gap, dp_gap[k][0]) for k, (gap, tol) in _dp_gaps(got, one, tr.learning_rate).items()
                 if not gap <= dp_gap[k][0] + tol}
        assert not worse, worse
    bad = _dp_violations(got, want, tr.learning_rate)
    assert not bad, bad
    # without the backward all-reduce every layer before a sharded one
    # gets a partial gradient
    partial = _dp_violations({k: zs[0][f"partial/{k}"] for k in want}, want, tr.learning_rate)
    assert any(k.startswith("grad/") for k in partial), partial
    assert max(partial.values()) > 100 * DP_TOL, partial
    # rank 0's checkpoint: the plain trainer's names and shapes
    from ssr_eval_tpu.models.checkpoint import restore_variables as j_restore

    plain = str(tmp_path / "plain_ckpt")
    tr.save(plain, state)
    got, ref = j_restore(str(ckpt) + ".npz"), j_restore(plain + ".npz")
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [(p, np.shape(v)) for p, v in flat_got] == [(p, np.shape(v)) for p, v in flat_ref]
    # the checkpoint holds the TP step's gathered parameters
    from ssr_eval_tpu_torch.models import convert

    sd = convert.nvsr_state_from_flax(got)
    for k, v in sd.items():
        if k.startswith("generator.") and f"param/{k[len('generator.'):]}" in want:
            assert np.array_equal(v.numpy(), zs[0][f"synced/param/{k[len('generator.'):]}"]), k


if __name__ == "__main__":
    main(*sys.argv[1:])
