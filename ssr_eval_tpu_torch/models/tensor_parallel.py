"""Output-channel tensor parallelism of the NVSR generator over a mesh's
"model" axis (the JAX trainer's `param_sharding`,
``ssr_eval_tpu/models/train.py:59-69``).

The rule is the JAX package's: a weight is sharded over "model" when it
has >= 2 dims and its output-channel count is >= 64 and divisible by tp;
everything else (biases, BatchNorm parameters and statistics, narrow
layers) is replicated.  The output-channel axis is dim 0 of a Conv and a
Linear weight and dim 1 of a ConvTranspose weight ([in, out, kh, kw]);
flax keeps it last for all three.  Each model rank keeps its slice of the
weight (and so AdamW keeps its moments for that slice only).

A sharded layer (`shard_generator` swaps its class, so parameter names do
not change):
- enters its input through `_CopyToModel`: identity forward, all-reduce
  over the model group backward (Megatron's "copy to model-parallel
  region"): each rank's slice gives only part of the input's gradient;
- computes its slice of the output channels without the bias;
- all-gathers the slices along the channel axis (`_GatherChannels`);
- adds the full, replicated bias.
BatchNorm and everything after a sharded layer see the full tensor, so
every model rank computes the same thing downstream.  That is why the
gather's backward takes this rank's slice of the gradient and reduces
nothing: `torch.distributed.nn.functional.all_gather` sums the tp ranks'
gradients, which are identical here, and so would scale every gradient
before it by tp per sharded layer.

The bigru generator's `nn.GRU` stays replicated (its Linears follow the
rule): sharding cuDNN's fused gates would need one gather per time step,
and the numbers are the same either way.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

MIN_SHARDED_CHANNELS = 64  # the JAX rule's floor on the output-channel count

_SHARDABLE = (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)  # the generators' weighted layers


def output_axis(module: nn.Module) -> int:
    """The output-channel axis of `module.weight`."""
    return 1 if isinstance(module, nn.ConvTranspose2d) else 0


def is_sharded(module: nn.Module, tp: int) -> bool:
    """Whether the JAX rule shards `module.weight` over a model axis of tp."""
    if tp <= 1 or not isinstance(module, _SHARDABLE):
        return False
    w = module.weight
    out = w.shape[output_axis(module)]
    return w.dim() >= 2 and out >= MIN_SHARDED_CHANNELS and out % tp == 0


def sharded_weight_names(model: nn.Module, tp: int) -> set[str]:
    """The state-dict names of the weights the rule shards."""
    return {f"{n}.weight" if n else "weight" for n, m in model.named_modules() if is_sharded(m, tp)}


class _CopyToModel(torch.autograd.Function):
    """Identity forward; all-reduce (sum) of the gradient over the model
    group backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _GatherChannels(torch.autograd.Function):
    """All-gather of the model ranks' slices along `dim`, in rank order;
    backward: this rank's slice of the (replicated) gradient."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, grad):
        n = grad.shape[ctx.dim] // dist.get_world_size(ctx.group)
        return grad.narrow(ctx.dim, dist.get_rank(ctx.group) * n, n).contiguous(), None, None


class _ColumnSharded:
    """Forward of a layer holding a slice of its output channels (mixed in
    before the torch layer class; `shard_generator` sets tp_group)."""

    tp_group = None
    channel_dim = 1  # of the output: NCHW for convs

    def forward(self, x):
        y = _GatherChannels.apply(self._slice_forward(_CopyToModel.apply(x, self.tp_group)), self.tp_group,
                                  self.channel_dim)
        if self.bias is None:
            return y
        shape = [-1] + [1] * (y.dim() - 1 - self.channel_dim % y.dim())
        return y + self.bias.reshape(shape)


class ShardedConv2d(_ColumnSharded, nn.Conv2d):
    def _slice_forward(self, x):
        return self._conv_forward(x, self.weight, None)


class ShardedConvTranspose2d(_ColumnSharded, nn.ConvTranspose2d):
    def _slice_forward(self, x):
        return F.conv_transpose2d(x, self.weight, None, self.stride, self.padding, self.output_padding,
                                  self.groups, self.dilation)


class ShardedLinear(_ColumnSharded, nn.Linear):
    channel_dim = -1

    def _slice_forward(self, x):
        return F.linear(x, self.weight)


_SHARDED_CLASS = {nn.Conv2d: ShardedConv2d, nn.ConvTranspose2d: ShardedConvTranspose2d, nn.Linear: ShardedLinear}


def shard_generator(model: nn.Module, mesh) -> None:
    """Shard `model` in place over `mesh`'s "model" axis: each weight the
    rule selects becomes this rank's slice of its output channels and its
    layer a Sharded* class.  Call before building the optimizer."""
    tp, rank, group = mesh.tp, mesh.model_rank, mesh.groups.get("model")
    for name, m in model.named_modules():
        if isinstance(m, _ColumnSharded) or not is_sharded(m, tp):
            continue
        if getattr(m, "groups", 1) != 1:
            raise ValueError(f"{name}: a grouped convolution cannot be sharded over its output channels")
        ax = output_axis(m)
        n = m.weight.shape[ax] // tp
        m.weight = nn.Parameter(m.weight.detach().narrow(ax, rank * n, n).clone())
        m.__class__ = _SHARDED_CLASS[type(m)]
        m.tp_group = group


def full_state_dict(model: nn.Module) -> dict:
    """`model.state_dict()` with every sharded weight gathered back to its
    full shape (collective over each model group: every rank calls it)."""
    state = model.state_dict()
    for name, m in model.named_modules():
        if isinstance(m, _ColumnSharded):
            w = m.weight.detach().contiguous()
            parts = [torch.empty_like(w) for _ in range(dist.get_world_size(m.tp_group))]
            dist.all_gather(parts, w, group=m.tp_group)
            state[f"{name}.weight"] = torch.cat(parts, output_axis(m))
    return state
