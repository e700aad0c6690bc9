"""The NVSR analysis UNet (65 M parameters at the published widths).

Architecture of reference examples/NVSR/components/unet.py
(UNetResComplex_100Mb, :414-590), as the JAX package's `models/unet.py`
builds it: 6 encoder groups of 4 pre-activation residual conv blocks + 2x2
avg-pool (channels 32/64/128/256/384/384), a center residual block, 6
mirrored decoder groups (BN -> ReLU -> 3x3 stride-2 transposed conv,
time-pruned, skip-concat, 4 residual blocks), a final residual block and a
1x1 head; the time axis padded to a multiple of 2^6 and the last frequency
bin dropped and restored (:552-559, 585-587).

Layout is NCHW ([B, C, T, F]) and the attribute names are the reference's
torch names (`encoder_block1.conv_block1.bn1`, `conv1`, `bn2`, `conv2`,
`shortcut`, `conv_block7`, `decoder_block{i}.conv1`, `after_conv_block1`,
`after_conv2`), so a reference state dict loads with `load_state_dict`.
Channel counts are explicit (torch builds modules eagerly): every block is
told its input width.  Every BatchNorm trains as flax's does
(`FlaxBatchNorm`), so `.train()` follows the JAX package's `train=True`.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint


class FlaxBatchNorm:
    """flax.linen.BatchNorm(momentum=0.99)'s training semantics on a torch
    BatchNorm (mixed in before nn.BatchNorm1d / 2d, built with momentum
    0.01): in train mode the batch statistics normalise, and the running
    statistics move 0.01 of the way to the batch mean and the BIASED batch
    variance (torch's own update takes the unbiased one).  flax keeps no
    batch count, so num_batches_tracked stays as loaded.  Eval mode reads the
    running statistics as torch does.

    `sync_stats` (set by a data-parallel trainer) takes the statistics over
    the rows of every rank of `stats_group` (None: the default process
    group; the trainer's mesh gives its "data" axis), as flax's are taken
    over a batch sharded on "data": the per-channel mean and mean of
    squares go through one autograd-aware all-reduce.

    `recomputing` is set while `UNetRes(remat=True)` recomputes a group's
    forward for the backward: the running statistics then stay as the
    first pass left them (flax's remat keeps the primal pass's
    `batch_stats` only).  The moments themselves are recomputed, their
    all-reduce included, as jax.checkpoint recomputes a psum."""

    sync_stats = False
    stats_group = None
    recomputing = False

    def forward(self, x):
        if not self.training:
            return super().forward(x)
        dims = [0, *range(2, x.dim())]
        shape = [1, -1] + [1] * (x.dim() - 2)
        if self.sync_stats:
            mean, mean_sq = _global_moments(x, dims, self.stats_group)
        else:
            mean, mean_sq = x.mean(dims), (x * x).mean(dims)
        var = torch.clamp(mean_sq - mean * mean, min=0.0)
        if not self.recomputing:
            self._update_running(mean, var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)

    @torch.no_grad()
    def _update_running(self, mean, var):
        self.running_mean.lerp_(mean, self.momentum)
        self.running_var.lerp_(var, self.momentum)


def _global_moments(x, dims, group=None):
    """(mean, mean of squares) per channel over the rows of every rank of
    `group` (None: the default group): the average over ranks of each
    rank's own moments, which is the global batch's because every rank
    holds as many rows (the data-parallel trainer splits the global batch
    evenly).  At one rank the result is the local moments bit for bit, so
    the step is the plain step's."""
    import torch.distributed as dist
    from torch.distributed.nn.functional import all_reduce

    group = dist.group.WORLD if group is None else group
    tot = all_reduce(torch.stack([x.mean(dims), (x * x).mean(dims)]), group=group) / dist.get_world_size(group)
    return tot[0], tot[1]


@contextlib.contextmanager
def _recomputing(module):
    """Mark every FlaxBatchNorm inside `module` as recomputing."""
    bns = [m for m in module.modules() if isinstance(m, FlaxBatchNorm)]
    for m in bns:
        m.recomputing = True
    try:
        yield
    finally:
        for m in bns:
            m.recomputing = False


class BatchNorm2d(FlaxBatchNorm, nn.BatchNorm2d):
    def __init__(self, num_features: int):
        super().__init__(num_features, momentum=0.01)


class ConvBlockRes(nn.Module):
    """Pre-activation residual block (reference unet.py:289-352):
    BN -> leaky_relu(0.01) -> 3x3 conv -> BN -> leaky_relu -> 3x3 conv, with
    a biased 1x1 shortcut when the channel counts differ.

    `fold_bn=True` is the inference-only folded form (models/fold_bn.py):
    bn2 lives inside conv1's weights and a new conv1 bias."""

    def __init__(self, in_ch: int, out_ch: int, fold_bn: bool = False):
        super().__init__()
        self.fold_bn = fold_bn
        self.bn1 = BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=fold_bn)
        if not fold_bn:
            self.bn2 = BatchNorm2d(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1, bias=False)
        if in_ch != out_ch:
            self.shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        h = F.leaky_relu(self.bn1(x), 0.01)
        h = self.conv1(h)
        if not self.fold_bn:
            h = self.bn2(h)
        h = self.conv2(F.leaky_relu(h, 0.01))
        if hasattr(self, "shortcut"):
            x = self.shortcut(x)
        return x + h


class EncoderGroup(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, blocks: int = 4, fold_bn: bool = False):
        super().__init__()
        self.blocks = blocks
        for i in range(blocks):
            setattr(self, f"conv_block{i + 1}", ConvBlockRes(in_ch if i == 0 else out_ch, out_ch, fold_bn))

    def forward(self, x):
        for i in range(self.blocks):
            x = getattr(self, f"conv_block{i + 1}")(x)
        return F.avg_pool2d(x, 2, 2), x


class DecoderGroup(nn.Module):
    """BN -> ReLU -> stride-2 3x3 transposed conv -> prune the last time row
    -> concat skip -> residual blocks (reference unet.py:235-287)."""

    def __init__(self, in_ch: int, out_ch: int, blocks: int = 4, fold_bn: bool = False):
        super().__init__()
        self.blocks = blocks
        self.bn1 = BatchNorm2d(in_ch)
        self.conv1 = nn.ConvTranspose2d(in_ch, out_ch, 3, stride=2, padding=0, bias=False)
        for i in range(blocks):
            setattr(self, f"conv_block{i + 2}", ConvBlockRes(2 * out_ch if i == 0 else out_ch, out_ch, fold_bn))

    def forward(self, x, skip):
        h = self.conv1(F.relu(self.bn1(x)))
        # prune: (T-1)*2+3 -> 2T rows of time; frequency 2F+1 matches skip
        h = torch.cat([h[:, :, :-1, :], skip], dim=1)
        for i in range(self.blocks):
            h = getattr(self, f"conv_block{i + 2}")(h)
        return h


class UNetRes(nn.Module):
    """UNet over [B, C, T, F] log-mel images -> {"mel": [B, C, T, F]}.

    `remat=True` recomputes each encoder/decoder group's forward during the
    backward (`torch.utils.checkpoint`, non-reentrant) instead of holding
    its activations, as the JAX package's `nn.remat` over `EncoderGroup` /
    `DecoderGroup` does: the same loss, gradients and running statistics,
    less memory, about one more forward of the groups.  It acts in train
    mode with gradients enabled; nothing in the generator or trainer sets
    it."""

    def __init__(
        self,
        channels: int = 1,
        widths: Sequence[int] = (32, 64, 128, 256, 384, 384),
        blocks_per_group: int = 4,
        fold_bn: bool = False,
        remat: bool = False,
    ):
        super().__init__()
        self.remat = remat
        self.widths = tuple(widths)
        in_ch = channels
        for i, w in enumerate(self.widths):
            setattr(self, f"encoder_block{i + 1}", EncoderGroup(in_ch, w, blocks_per_group, fold_bn))
            in_ch = w
        self.conv_block7 = ConvBlockRes(in_ch, self.widths[-1], fold_bn)
        in_ch = self.widths[-1]
        for i, w in enumerate(self.widths[::-1]):  # 384, 384, 256, 128, 64, 32
            setattr(self, f"decoder_block{i + 1}", DecoderGroup(in_ch, w, blocks_per_group, fold_bn))
            in_ch = w
        self.after_conv_block1 = ConvBlockRes(in_ch, self.widths[0], fold_bn)
        self.after_conv2 = nn.Conv2d(self.widths[0], channels, 1)

    def forward(self, x):
        origin_len = x.shape[2]
        ratio = 2 ** len(self.widths)
        pad_len = -(-origin_len // ratio) * ratio - origin_len
        x = F.pad(x, (0, 0, 0, pad_len))
        h = x[:, :, :, : x.shape[3] - 1]  # drop the last frequency bin (128 -> 127)

        skips = []
        for i in range(len(self.widths)):
            h, skip = self._group(getattr(self, f"encoder_block{i + 1}"), h)
            skips.append(skip)
        h = self.conv_block7(h)
        for i in range(len(self.widths)):
            h = self._group(getattr(self, f"decoder_block{i + 1}"), h, skips[-(i + 1)])
        h = self.after_conv2(self.after_conv_block1(h)).to(torch.float32)

        h = F.pad(h, (0, 1))  # restore the frequency bin
        return {"mel": h[:, :, :origin_len, :]}


    def _group(self, group, *args):
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return group(*args)
        return checkpoint(
            group, *args, use_reentrant=False,
            context_fn=lambda: (contextlib.nullcontext(), _recomputing(group)),
        )


def UNetResComplex_100Mb(channels: int = 1, **kw):
    """Reference-named constructor (examples/NVSR/components/unet.py:414):
    the 6-level Res4B UNet at the published widths.  `unet_small`'s Res1B
    variant is the same configuration (the reference's unet_small.py is a
    class-rename of unet.py)."""
    return UNetRes(channels=channels, **kw)
