"""Neural vocoders: mel [B, T, n_mels] -> waveform [B, T * 441].

- `TFGANGenerator` / `Vocoder`: the structure of voicefixer's 44.1 kHz
  vocoder (the reference's NVSR vocoder, examples/NVSR/nvsr_unet.py:84), as
  the JAX package's `models/vocoder.py` reconstructs it: a Conv1d prenet,
  four ConvTranspose1d upsampling stages factorizing the 441-sample hop
  (7*7*3*3, each cut to exactly L*r), a dilated residual stack after each
  stage, and a tanh'd Conv1d head.  Weight norm is fused when a voicefixer
  state dict is loaded (models/convert.py), so these are plain convs.
- `HiFiGANVocoder`: the JAX package's own HiFiGAN-style MRF generator.

Module names (`pre`, `up_i`, `res_i_j_d`, `res_i_j_p`, `post` under
`model`) are the JAX package's, so one name map serves both packages.
Tensors are [B, C, L] inside; the public shapes are the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class TFGANConfig:
    """voicefixer-structure vocoder hyperparameters (44.1 kHz preset).

    The mel front-end constants follow the tacotron-style normalization
    voicefixer applies before its generator (amp->db, clip to
    [-max_abs, max_abs]); they are data-independent scalars.
    """

    n_mels: int = 128
    channels: int = 512
    ratios: Sequence[int] = (7, 7, 3, 3)
    res_dilations: Sequence[int] = (1, 3, 9)
    # Per-upsample-stage output widths; None = halve each stage (the
    # voicefixer/MelGAN convention).  convert.infer_vocoder_config fills
    # this from a checkpoint's shapes when they deviate.
    stage_channels: Sequence[int] | None = None
    pre_kernel: int = 7
    post_kernel: int = 7
    res_kernel: int = 3
    leaky: float = 0.2
    # mel normalization (voicefixer vocoder front end)
    min_db: float = -115.0
    max_abs: float = 4.0
    ref_db: float = 20.0

    def stage_width(self, i: int) -> int:
        if self.stage_channels is not None:
            return int(self.stage_channels[i])
        return self.channels >> (i + 1)


def normalize_mel(mel, cfg: TFGANConfig):
    """Linear mel -> normalized generator conditioning (amp->db->[-A, A])."""
    db = 20.0 * torch.log10(torch.clamp(mel, min=1e-5)) - cfg.ref_db
    s = (2.0 * cfg.max_abs) * ((db - cfg.min_db) / (-cfg.min_db)) - cfg.max_abs
    return torch.clamp(s, -cfg.max_abs, cfg.max_abs)


def _same_pad(kernel: int, dilation: int = 1) -> tuple[int, int]:
    """flax/lax 'SAME' padding of a stride-1 conv: (before, after)."""
    total = dilation * (kernel - 1)
    return total // 2, total - total // 2


def _conv_transpose_same_offset(kernel: int, stride: int) -> int:
    """Where lax.conv_transpose(padding='SAME') starts inside the full
    (VALID) transposed-conv output, which is torch's output at padding 0:
    the VALID result pads k-1 in front, 'SAME' pads k-1 when s > k-1 and
    ceil((k+s-2)/2) otherwise (jax._src.lax.convolution
    ._conv_transpose_padding).  It keeps L*s samples from there."""
    pad_a = kernel - 1 if stride > kernel - 1 else -(-(kernel + stride - 2) // 2)
    return kernel - 1 - pad_a


class _SameConv1d(nn.Conv1d):
    """Conv1d with flax's 'SAME' padding (odd or even kernels, any dilation)."""

    def __init__(self, in_ch, out_ch, kernel, dilation=1):
        super().__init__(in_ch, out_ch, kernel, dilation=dilation)
        self._pads = _same_pad(kernel, dilation)

    def forward(self, x):
        return super().forward(F.pad(x, self._pads))


class TFGANGenerator(nn.Module):
    """Conditioning [B, T, n_mels] -> waveform [B, T * prod(ratios)]."""

    def __init__(self, cfg: TFGANConfig = TFGANConfig()):
        super().__init__()
        self.cfg = cfg
        self.pre = _SameConv1d(cfg.n_mels, cfg.channels, cfg.pre_kernel)
        ch_in = cfg.channels
        for i, r in enumerate(cfg.ratios):
            ch = cfg.stage_width(i)
            setattr(self, f"up_{i}", nn.ConvTranspose1d(ch_in, ch, 2 * r, stride=r))
            for j, d in enumerate(cfg.res_dilations):
                setattr(self, f"res_{i}_{j}_d", nn.Conv1d(ch, ch, cfg.res_kernel, dilation=d))
                setattr(self, f"res_{i}_{j}_p", nn.Conv1d(ch, ch, 1))
            ch_in = ch
        self.post = _SameConv1d(ch_in, 1, cfg.post_kernel)

    def forward(self, cond):
        cfg = self.cfg
        a = cfg.leaky
        x = self.pre(cond.transpose(1, 2))
        for i, r in enumerate(cfg.ratios):
            x = F.leaky_relu(x, a)
            # torch ConvTranspose1d(k=2r, stride=r, padding=r//2) trims r//2
            # from both ends of the full output; voicefixer's UpsampleNet then
            # cuts to exactly L*r.  Together: full output [p : p + L*r].
            L, p = x.shape[2], r // 2
            x = getattr(self, f"up_{i}")(x)[:, :, p : p + L * r]
            for j, d in enumerate(cfg.res_dilations):
                pd = d * (cfg.res_kernel // 2)
                h = F.pad(F.leaky_relu(x, a), (pd, pd), mode="reflect")
                h = getattr(self, f"res_{i}_{j}_d")(h)
                h = getattr(self, f"res_{i}_{j}_p")(F.leaky_relu(h, a))
                x = x + h
        x = self.post(F.leaky_relu(x, a))
        return torch.tanh(x.to(torch.float32))[:, 0]


class Vocoder(nn.Module):
    """voicefixer-shaped wrapper: linear mel in, waveform out (normalize the
    mel, then the generator under the `model` attribute)."""

    def __init__(self, cfg: TFGANConfig = TFGANConfig()):
        super().__init__()
        self.cfg = cfg
        self.model = TFGANGenerator(cfg)

    def forward(self, mel):
        return self.model(normalize_mel(mel, self.cfg))


class ResBlock1(nn.Module):
    """HiFiGAN MRF residual block: dilated conv pairs with leaky relu."""

    def __init__(self, channels: int, kernel: int = 3, dilations: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.dilations = tuple(dilations)
        for i, d in enumerate(self.dilations):
            setattr(self, f"conv1_{i}", _SameConv1d(channels, channels, kernel, dilation=d))
            setattr(self, f"conv2_{i}", _SameConv1d(channels, channels, kernel))

    def forward(self, x):
        for i in range(len(self.dilations)):
            h = getattr(self, f"conv1_{i}")(F.leaky_relu(x, 0.1))
            x = x + getattr(self, f"conv2_{i}")(F.leaky_relu(h, 0.1))
        return x


class HiFiGANVocoder(nn.Module):
    """mel [B, T, n_mels] -> wav [B, T * prod(upsample_rates)]."""

    def __init__(
        self,
        n_mels: int = 128,
        base_channels: int = 512,
        upsample_rates: Sequence[int] = (7, 7, 3, 3),
        upsample_kernels: Sequence[int] = (14, 14, 6, 6),
        resblock_kernels: Sequence[int] = (3, 7, 11),
        resblock_dilations: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5)),
    ):
        super().__init__()
        self.upsample_rates = tuple(upsample_rates)
        self.upsample_kernels = tuple(upsample_kernels)
        self.n_res = len(resblock_kernels)
        self.conv_pre = _SameConv1d(n_mels, base_channels, 7)
        ch = base_channels
        for i, (r, k) in enumerate(zip(self.upsample_rates, self.upsample_kernels)):
            setattr(self, f"up_{i}", nn.ConvTranspose1d(ch, ch // 2, k, stride=r))
            ch //= 2
            for j, (rk, rd) in enumerate(zip(resblock_kernels, resblock_dilations)):
                setattr(self, f"res_{i}_{j}", ResBlock1(ch, rk, rd))
        self.conv_post = _SameConv1d(ch, 1, 7)

    def forward(self, mel):
        h = self.conv_pre(mel.transpose(1, 2))
        for i, (r, k) in enumerate(zip(self.upsample_rates, self.upsample_kernels)):
            L = h.shape[2]
            off = _conv_transpose_same_offset(k, r)
            h = getattr(self, f"up_{i}")(F.leaky_relu(h, 0.1))[:, :, off : off + L * r]
            # Multi-receptive-field fusion: mean of parallel resblocks.
            acc = None
            for j in range(self.n_res):
                b = getattr(self, f"res_{i}_{j}")(h)
                acc = b if acc is None else acc + b
            h = acc / self.n_res
        h = self.conv_post(F.leaky_relu(h, 0.1))
        return torch.tanh(h.to(torch.float32))[:, 0]
