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
told its input width.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class ConvBlockRes(nn.Module):
    """Pre-activation residual block (reference unet.py:289-352):
    BN -> leaky_relu(0.01) -> 3x3 conv -> BN -> leaky_relu -> 3x3 conv, with
    a biased 1x1 shortcut when the channel counts differ.

    `fold_bn=True` is the inference-only folded form (models/fold_bn.py):
    bn2 lives inside conv1's weights and a new conv1 bias."""

    def __init__(self, in_ch: int, out_ch: int, fold_bn: bool = False):
        super().__init__()
        self.fold_bn = fold_bn
        self.bn1 = nn.BatchNorm2d(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1, bias=fold_bn)
        if not fold_bn:
            self.bn2 = nn.BatchNorm2d(out_ch)
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
        self.bn1 = nn.BatchNorm2d(in_ch)
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
    """UNet over [B, C, T, F] log-mel images -> {"mel": [B, C, T, F]}."""

    def __init__(
        self,
        channels: int = 1,
        widths: Sequence[int] = (32, 64, 128, 256, 384, 384),
        blocks_per_group: int = 4,
        fold_bn: bool = False,
    ):
        super().__init__()
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
            h, skip = getattr(self, f"encoder_block{i + 1}")(h)
            skips.append(skip)
        h = self.conv_block7(h)
        for i in range(len(self.widths)):
            h = getattr(self, f"decoder_block{i + 1}")(h, skips[-(i + 1)])
        h = self.after_conv2(self.after_conv_block1(h)).to(torch.float32)

        h = F.pad(h, (0, 1))  # restore the frequency bin
        return {"mel": h[:, :, :origin_len, :]}


def UNetResComplex_100Mb(channels: int = 1, **kw):
    """Reference-named constructor (examples/NVSR/components/unet.py:414):
    the 6-level Res4B UNet at the published widths.  `unet_small`'s Res1B
    variant is the same configuration (the reference's unet_small.py is a
    class-rename of unet.py)."""
    return UNetRes(channels=channels, **kw)
