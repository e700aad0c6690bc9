"""NVSR generator training on one CUDA card.

Counterpart of ``ssr_eval_tpu.models.train.NVSRTrainer`` (the reference
never trains; this is the JAX package's native training path):

- loss: L1 in log-mel space between the generator's output and the
  high-resolution target, mean |out["mel"] - to_log(mel_hr)|;
- the generator in train mode: BatchNorm normalises with batch statistics
  and updates its running statistics as flax updates `batch_stats`
  (models/unet.py `FlaxBatchNorm`);
- optimizer: AdamW with optax.adamw's defaults (betas 0.9 / 0.999, eps
  1e-8, weight decay 1e-4; torch's default decay is 0.01) over every
  generator parameter.

JAX's state is immutable; here the state holds the generator module and its
optimizer, and `step` updates both in place.  Checkpoints are the JAX
package's `.npz` variables tree ({"params": {"generator": ...},
"batch_stats": {"generator": ...}}, `convert.flax_from_nvsr_state`), which
`NVSRTestee.load_generator_checkpoint` and the JAX package both read.

`mesh` (`make_mesh(tp=...)`): the JAX trainer's ("data", "model") mesh
over the ranks of the default torch.distributed process group, one card
per process, rank = d * tp + m.  Every rank is given the whole global
batch and takes the B/dp rows of its data index d; one all-reduce per
step over its "data" group, in a fixed order after `backward`, averages
the gradients (and the loss) over the dp ranks.  The BatchNorms take their
statistics over the global batch, as flax's do over a batch sharded on
"data": each averages its per-channel mean and mean of squares over the
data group through the autograd-aware
`torch.distributed.nn.functional.all_reduce` (every rank holds B/dp rows),
so the forward, the backward and the running statistics are the
one-process step's on the whole batch.  With tp > 1 the generator's wide
weights are sharded over "model" by output channel
(`models/tensor_parallel.py`, the JAX `param_sharding` rule; the bigru
generator's GRU stays replicated), and AdamW keeps each rank's slices
only; checkpoints gather them back to the plain trainer's names and
shapes.  tp defaults to 1, not to the JAX package's 2 when it divides the
device count: a 65M-parameter conv net gains nothing from an NCCL gather
per convolution, and either layout gives the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ssr_eval_tpu_torch.models.nvsr import NVSR, init_weights, to_log
from ssr_eval_tpu_torch.models.tensor_parallel import full_state_dict, shard_generator
from ssr_eval_tpu_torch.models.unet import FlaxBatchNorm
from ssr_eval_tpu_torch.parallel.mesh import DataMesh, as_data_mesh, device_mesh, group_rank_and_size, mesh_device


def adamw(params, learning_rate):
    """torch AdamW with optax.adamw's defaults."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def make_mesh(n_devices=None, tp=None, device=None) -> DataMesh:
    """The trainer's ("data", "model") mesh over the default process
    group's ranks (`parallel.device_mesh(tp, device)`; every rank calls it,
    in the same order).

    n_devices: the ranks expected; a group of another size raises (one card
    per process: start that many processes, each calling
    `parallel.multihost.init_distributed`).  tp: the "model" axis; None is
    1 (the JAX package takes 2 when it divides the device count; see the
    module docstring).  A world size that tp does not divide raises
    ValueError."""
    world = group_rank_and_size()[1]
    if n_devices is not None and n_devices != world:
        raise ValueError(
            f"make_mesh: requested {n_devices} devices but the process group has {world} rank(s), one "
            "card each: start that many processes and call parallel.multihost.init_distributed in each"
        )
    return device_mesh(1 if tp is None else int(tp), device)


class NVSRTrainer:
    """Generator training.  device: None is the CUDA card (raises without
    one), "cpu" the CPU; mesh: None, or `make_mesh()` for data parallelism
    (the device is then the mesh's)."""

    def __init__(self, model_name="unet", learning_rate=1e-4, mesh=None, device=None):
        self.mesh = as_data_mesh(mesh, "NVSRTrainer")
        self.device = mesh_device(self.mesh, device)
        # collectives run whenever a process group backs the mesh, even
        # one of a single rank
        self._synced = self.mesh is not None and dist.is_available() and dist.is_initialized()
        self.model = NVSR(model_name=model_name)
        self.learning_rate = learning_rate

    def init_state(self, seed: int = 0, params=None):
        """{"model": the generator in train mode on the device, "opt": its
        AdamW}.  Weights: `params`, the JAX package's variables tree of the
        generator ({"params": {"generator": ...}, "batch_stats": ...}, as
        NumPy arrays), else `nvsr.init_weights(seed)`, flax's default draw
        (truncated LeCun normal kernels, orthogonal GRU recurrent gates)."""
        gen = self.model.generator
        if params is not None:
            from ssr_eval_tpu_torch.models.convert import nvsr_state_from_flax

            sub = {c: {"generator": params[c]["generator"]} for c in ("params", "batch_stats") if c in params}
            state = nvsr_state_from_flax(sub)
            gen.load_state_dict({k[len("generator."):]: v for k, v in state.items()})
        else:
            init_weights(gen, seed)
        gen.to(self.device).train()
        if self._synced:
            for m in gen.modules():
                if isinstance(m, FlaxBatchNorm):
                    m.sync_stats = True
                    m.stats_group = self.mesh.groups.get("data")
            if self.mesh.tp > 1:
                shard_generator(gen, self.mesh)
        return {"model": gen, "opt": adamw(gen.parameters(), self.learning_rate)}

    @staticmethod
    def loss(gen, mel_lr, mel_hr):
        """mean |gen(mel_lr)["mel"] - to_log(mel_hr)| (train-mode forward)."""
        return torch.mean(torch.abs(gen(mel_lr)["mel"] - to_log(mel_hr)))

    def step(self, state, mel_lr, mel_hr):
        """One AdamW step on a batch [B, T, M] -> (state, loss as a 0-d
        tensor on the device).  With a mesh the batch is the global one
        (the same on every rank): this rank trains on the B/dp rows of its
        data index, and the loss returned is the global batch's."""
        opt = state["opt"]
        opt.zero_grad(set_to_none=True)
        if self._synced:
            mel_lr, mel_hr = self._local_rows(mel_lr), self._local_rows(mel_hr)
        loss = self.loss(state["model"], mel_lr, mel_hr)
        loss.backward()
        if self._synced:
            loss = self._average_over_ranks(state["model"], loss)
        opt.step()
        return state, loss.detach()

    def _local_rows(self, x):
        W, r = self.mesh.size, self.mesh.data_rank
        if x.shape[0] % W:
            raise ValueError(f"a global batch of {x.shape[0]} rows does not split over {W} data ranks")
        n = x.shape[0] // W
        return x[r * n : (r + 1) * n]

    def _average_over_ranks(self, gen, loss):
        """One all-reduce over the data group of [loss, every gradient] in
        parameter order; each divided by dp.  -> the global loss."""
        grads = [p.grad for p in gen.parameters() if p.grad is not None]
        flat = torch.cat([loss.detach().reshape(1)] + [g.reshape(-1) for g in grads])
        dist.all_reduce(flat, group=self.mesh.groups.get("data"))
        flat /= self.mesh.size
        off = 1
        for g in grads:
            g.copy_(flat[off : off + g.numel()].view_as(g))
            off += g.numel()
        return flat[0]

    def fit(
        self,
        audios,
        steps: int = 100,
        batch: int = 8,
        crop_seconds: float = 1.0,
        seed: int = 0,
        ckpt_path: str | None = None,
        ckpt_every: int = 50,
        log_every: int = 10,
        cutoffs=(2000, 4000, 8000, 12000),
    ):
        """Train the mel generator on HR audio with on-device degradation.

        audios: list of float32 HR waveforms at 44.1 kHz (host).  Returns
        (state, losses).  Writes a checkpoint every `ckpt_every` steps when
        `ckpt_path` is given (rank 0 writes it; with a mesh every rank takes
        part in gathering the sharded weights)."""
        from ssr_eval_tpu_torch.models.data import MelPairPipeline

        pipe = MelPairPipeline(crop_seconds=crop_seconds, cutoffs=cutoffs, device=self.device)
        rng = np.random.default_rng(seed)
        state = self.init_state(seed)
        losses = []
        for step in range(steps):
            wav = pipe.random_crops(audios, rng, batch)
            mel_lr, mel_hr = pipe.make_pair(wav, spec_idx=step)
            state, loss = self.step(state, mel_lr, mel_hr)
            losses.append(float(loss))
            if log_every and step % log_every == 0:
                print(f"[train] step {step} loss {losses[-1]:.4f}")
            if ckpt_path and ckpt_every and (step + 1) % ckpt_every == 0:
                self.save(ckpt_path, state)
        return state, losses

    def variables(self, state) -> dict:
        """The generator's weights as the JAX package's variables tree, the
        sharded weights gathered to their full shapes (with a mesh every
        rank must call it)."""
        from ssr_eval_tpu_torch.models.convert import flax_from_nvsr_state

        return flax_from_nvsr_state({f"generator.{k}": v for k, v in full_state_dict(state["model"]).items()})

    def save(self, path: str, state) -> str | None:
        """Write the generator's `.npz` checkpoint; returns its path.  With
        a mesh every rank calls it (the gather) and rank 0 alone writes;
        the other ranks return None."""
        from ssr_eval_tpu_torch.models.checkpoint import save_variables

        variables = self.variables(state)
        if self.mesh is not None and self.mesh.rank != 0:
            return None
        return save_variables(path, variables)

    def make_batch(self, seed, batch, t_frames=64, n_mels=128):
        """A synthetic (mel_lr, mel_hr) batch made with NumPy from `seed`:
        mel_lr = |N(0, 1)| + 1e-3, mel_hr = mel_lr + 0.1 |N(0, 1)|."""
        rng = np.random.default_rng(seed)
        mel_lr = np.abs(rng.standard_normal((batch, t_frames, n_mels))).astype(np.float32) + np.float32(1e-3)
        mel_hr = mel_lr + np.float32(0.1) * np.abs(rng.standard_normal(mel_lr.shape)).astype(np.float32)
        return torch.from_numpy(mel_lr).to(self.device), torch.from_numpy(mel_hr).to(self.device)
