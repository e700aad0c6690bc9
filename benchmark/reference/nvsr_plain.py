"""NVSR in plain PyTorch, one utterance at a time, unpadded.

Written from the published structure (Liu et al., arXiv:2203.14941;
haoheliu/ssr_eval examples/NVSR: nvsr_unet.py:71-139, components/unet.py
UNetResComplex_100Mb :235-590, main.py:22-35 and :96-109), for the
benchmark's comparison.  It imports nothing of the program under test.
Weights come as two dicts of tensors in the reference's state-dict
layouts: {"unet": `generator.analysis_module.*` (as the Zenodo checkpoint
names the UNet), "vocoder": voicefixer's `generator.<i>...` Sequential
names}.

    wav [S, n] --|STFT| 2048/441, power floor 1e-8--> sp [S, T, 1025]
    sp --mel filterbank (128, HTK, 0-22050 Hz)--> mel;   T = n // 441 + 1
    log_mel = log10(max(mel, 1e-8))
    out = UNet(log_mel) + log_mel;   mel' = 10 ** min(out, 5)
    wav' = vocoder(mel') [S, T * 441];   trim about n: start (T * 441 - n) // 2

The networks run in float32 with TF32 off (`infer` pins both switches for
its call and restores them); the STFT and the mel run in the input's dtype.
`rnd` is applied to both operands of every product-sum (the filterbank,
every convolution): `identity` for the reference, `benchmark.reference.dsp.tf32`
for the control.

Departures, each a choice of this file:
- the vocoder is the voicefixer-structure TF-GAN generator as this
  repository reconstructs it (voicefixer's source is not in the
  repository): a 7-tap Conv1d prenet, four ConvTranspose1d stages (kernel
  2r, stride r, the full output cut to [r // 2, r // 2 + L * r]), after
  each a stack of three residual blocks (leaky ReLU 0.2, reflect padding,
  3-tap conv at dilation 1, 3, 9, leaky ReLU, 1x1 conv), a 7-tap Conv1d
  head and tanh; the prenet and head pad with zeros ("same");
  conditioning is voicefixer's amp -> dB (ref 20 dB, floor 1e-5) scaled
  to [-4, 4] from a -115 dB floor;
- the vocoder's weights are plain `weight` / `bias` (a checkpoint's weight
  norm, `weight_g` / `weight_v`, is fused by `fuse_weight_norm` when given);
- the filterbank is computed in float64 (torchaudio's MelScale holds it in
  float32);
- BatchNorm runs in eval mode with eps 1e-5 (torch's default);
- reference main.py's trim keeps nothing when the lengths differ by 1
  (`est[..., 0:-0]`); here the trim keeps n samples from (T * 441 - n) // 2
  in every case.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

N_FFT, HOP, SR, N_MELS = 2048, 441, 44100, 128
POWER_FLOOR = 1e-8
UNET_WIDTHS = (32, 64, 128, 256, 384, 384)
UNET_BLOCKS = 4
UNET = "generator.analysis_module."
VOC_CHANNELS, VOC_RATIOS, VOC_DILATIONS = 512, (7, 7, 3, 3), (1, 3, 9)
VOC_PRE_K, VOC_POST_K, VOC_RES_K, VOC_LEAKY = 7, 7, 3, 0.2
MIN_DB, MAX_ABS, REF_DB = -115.0, 4.0, 20.0
BN_EPS = 1e-5


def identity(t: torch.Tensor) -> torch.Tensor:
    return t


# ----------------------------------------------------------------------
# Front end
# ----------------------------------------------------------------------


def mel_filterbank(n_freqs: int = N_FFT // 2 + 1, n_mels: int = N_MELS, sr: int = SR) -> np.ndarray:
    """Triangular HTK mel filterbank [n_freqs, n_mels] from 0 Hz to sr / 2,
    unnormalised (torchaudio.functional.melscale_fbanks' defaults)."""
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    freqs = np.linspace(0, sr // 2, n_freqs)
    m = np.linspace(hz_to_mel(0.0), hz_to_mel(sr / 2), n_mels + 2)
    f_pts = 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_diff = np.diff(f_pts)
    slopes = f_pts[None, :] - freqs[:, None]
    down = -slopes[:, :-2] / f_diff[:-1]
    up = slopes[:, 2:] / f_diff[1:]
    return np.maximum(0.0, np.minimum(down, up))


def stft_magnitude(x: torch.Tensor) -> torch.Tensor:
    """x [S, n] -> sqrt(max(|STFT|^2, 1e-8)) [S, n // 441 + 1, 1025]:
    centred, reflect padding of 1024, periodic Hann of 2048."""
    k = torch.arange(N_FFT, device=x.device, dtype=torch.float64)
    win = (0.5 - 0.5 * torch.cos(2 * math.pi * k / N_FFT)).to(x.dtype)
    xp = F.pad(x[:, None], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    z = torch.fft.rfft(xp.unfold(-1, N_FFT, HOP) * win, dim=-1)
    return torch.sqrt(torch.clamp(z.real**2 + z.imag**2, min=POWER_FLOOR))


def mel_of(x: torch.Tensor, rnd=identity) -> torch.Tensor:
    """x [S, n] -> mel [S, T, 128] in x's dtype."""
    fb = torch.from_numpy(mel_filterbank()).to(x.device, x.dtype)
    return torch.matmul(rnd(stft_magnitude(x)), rnd(fb)).to(x.dtype)


# ----------------------------------------------------------------------
# The UNet (components/unet.py UNetResComplex_100Mb)
# ----------------------------------------------------------------------


def _bn(x, w, name):
    shape = [1, -1] + [1] * (x.dim() - 2)
    scale = w[name + ".weight"] / torch.sqrt(w[name + ".running_var"] + BN_EPS)
    return (x - w[name + ".running_mean"].reshape(shape)) * scale.reshape(shape) + w[name + ".bias"].reshape(shape)


def _conv2d(x, w, name, rnd, padding):
    return F.conv2d(rnd(x), rnd(w[name + ".weight"]), w.get(name + ".bias"), padding=padding)


def _res_block(x, w, name, rnd):
    """ConvBlockRes (:289-352): BN, leaky ReLU 0.01, 3x3 conv, BN, leaky
    ReLU, 3x3 conv, plus x (through a biased 1x1 conv when the widths
    differ)."""
    h = _conv2d(F.leaky_relu(_bn(x, w, name + ".bn1"), 0.01), w, name + ".conv1", rnd, 1)
    h = _conv2d(F.leaky_relu(_bn(h, w, name + ".bn2"), 0.01), w, name + ".conv2", rnd, 1)
    if name + ".shortcut.weight" in w:
        x = _conv2d(x, w, name + ".shortcut", rnd, 0)
    return x + h


def unet(log_mel: torch.Tensor, w: dict, rnd=identity) -> torch.Tensor:
    """log_mel [S, T, 128] -> [S, T, 128]: time zero-padded to a multiple of
    64 and the last bin dropped (:552-559); six encoder groups of four
    blocks and a 2x2 average pool; a centre block; six decoder groups (BN,
    ReLU, 3x3 stride-2 transposed conv, the last time row pruned, the skip
    concatenated, four blocks); a block and a 1x1 conv; the bin restored
    and the padding cut (:585-587)."""
    T = log_mel.shape[1]
    ratio = 2 ** len(UNET_WIDTHS)
    x = F.pad(log_mel[:, None], (0, 0, 0, -(-T // ratio) * ratio - T))[..., :-1]
    skips = []
    for i in range(1, len(UNET_WIDTHS) + 1):
        for b in range(1, UNET_BLOCKS + 1):
            x = _res_block(x, w, f"{UNET}encoder_block{i}.conv_block{b}", rnd)
        skips.append(x)
        x = F.avg_pool2d(x, 2)
    x = _res_block(x, w, f"{UNET}conv_block7", rnd)
    for i in range(1, len(UNET_WIDTHS) + 1):
        name = f"{UNET}decoder_block{i}"
        h = F.conv_transpose2d(rnd(F.relu(_bn(x, w, name + ".bn1"))), rnd(w[name + ".conv1.weight"]), stride=2)
        x = torch.cat([h[:, :, :-1], skips[-i]], dim=1)
        for b in range(2, UNET_BLOCKS + 2):
            x = _res_block(x, w, f"{name}.conv_block{b}", rnd)
    x = _conv2d(_res_block(x, w, f"{UNET}after_conv_block1", rnd), w, f"{UNET}after_conv2", rnd, 0)
    return F.pad(x, (0, 1))[:, 0, :T]


# ----------------------------------------------------------------------
# The vocoder (voicefixer structure; see the departures above)
# ----------------------------------------------------------------------


def fuse_weight_norm(v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """torch weight_norm (dim 0): g * v / ||v||, the norm over all but dim 0."""
    norm = v.double().pow(2).sum(dim=tuple(range(1, v.dim())), keepdim=True).sqrt()
    return (v.double() * (g.double() / norm)).to(v.dtype)


def _weight(w, name):
    if name + ".weight" in w:
        return w[name + ".weight"]
    return fuse_weight_norm(w[name + ".weight_v"], w[name + ".weight_g"])


def _conv1d(x, w, name, rnd, dilation=1):
    return F.conv1d(rnd(x), rnd(_weight(w, name)), w.get(name + ".bias"), dilation=dilation)


def vocoder(mel: torch.Tensor, w: dict, rnd=identity) -> torch.Tensor:
    """Linear mel [S, T, 128] -> waveform [S, T * 441]."""
    a = VOC_LEAKY
    db = 20.0 * torch.log10(torch.clamp(mel, min=1e-5)) - REF_DB
    cond = torch.clamp(2 * MAX_ABS * (db - MIN_DB) / -MIN_DB - MAX_ABS, -MAX_ABS, MAX_ABS)
    x = _conv1d(F.pad(cond.transpose(1, 2), (VOC_PRE_K // 2, VOC_PRE_K // 2)), w, "generator.0", rnd)
    idx = 2
    for r in VOC_RATIOS:
        L, p = x.shape[2], r // 2
        up = f"generator.{idx}.layer"
        x = F.conv_transpose1d(rnd(F.leaky_relu(x, a)), rnd(_weight(w, up)), w.get(up + ".bias"), stride=r)
        x = x[:, :, p : p + L * r]
        for j, d in enumerate(VOC_DILATIONS):
            pd = d * (VOC_RES_K // 2)
            h = F.pad(F.leaky_relu(x, a), (pd, pd), mode="reflect")
            h = _conv1d(h, w, f"generator.{idx + 1}.blocks.{j}.2", rnd, dilation=d)
            x = x + _conv1d(F.leaky_relu(h, a), w, f"generator.{idx + 1}.blocks.{j}.4", rnd)
        idx += 3
    x = _conv1d(F.pad(F.leaky_relu(x, a), (VOC_POST_K // 2, VOC_POST_K // 2)), w, f"generator.{idx}", rnd)
    return torch.tanh(x)[:, 0]


# ----------------------------------------------------------------------
# The layouts
# ----------------------------------------------------------------------


def unet_layout() -> dict:
    """{name: (shape, kind)} of every entry of the UNet's state dict, under
    `generator.analysis_module.`; kind is "conv", "convT" (weights, with
    torch's layouts), "bias", "bn_weight", "bn_bias", "bn_mean", "bn_var"
    or "bn_count"."""
    out = {}

    def bn(name, ch):
        for leaf, kind in (("weight", "bn_weight"), ("bias", "bn_bias"), ("running_mean", "bn_mean"),
                           ("running_var", "bn_var")):
            out[f"{UNET}{name}.{leaf}"] = ((ch,), kind)
        out[f"{UNET}{name}.num_batches_tracked"] = ((), "bn_count")

    def block(name, cin, cout):
        bn(name + ".bn1", cin)
        out[f"{UNET}{name}.conv1.weight"] = ((cout, cin, 3, 3), "conv")
        bn(name + ".bn2", cout)
        out[f"{UNET}{name}.conv2.weight"] = ((cout, cout, 3, 3), "conv")
        if cin != cout:
            out[f"{UNET}{name}.shortcut.weight"] = ((cout, cin, 1, 1), "conv")
            out[f"{UNET}{name}.shortcut.bias"] = ((cout,), "bias")

    cin = 1
    for i, wd in enumerate(UNET_WIDTHS, start=1):
        for b in range(1, UNET_BLOCKS + 1):
            block(f"encoder_block{i}.conv_block{b}", cin if b == 1 else wd, wd)
        cin = wd
    block("conv_block7", cin, UNET_WIDTHS[-1])
    cin = UNET_WIDTHS[-1]
    for i, wd in enumerate(UNET_WIDTHS[::-1], start=1):
        bn(f"decoder_block{i}.bn1", cin)
        out[f"{UNET}decoder_block{i}.conv1.weight"] = ((cin, wd, 3, 3), "convT")
        for b in range(2, UNET_BLOCKS + 2):
            block(f"decoder_block{i}.conv_block{b}", 2 * wd if b == 2 else wd, wd)
        cin = wd
    block("after_conv_block1", cin, UNET_WIDTHS[0])
    out[f"{UNET}after_conv2.weight"] = ((1, UNET_WIDTHS[0], 1, 1), "conv")
    out[f"{UNET}after_conv2.bias"] = ((1,), "bias")
    return out


def vocoder_layout() -> dict:
    """{name: (shape, kind)} of the vocoder's voicefixer-named entries."""
    out = {"generator.0.weight": ((VOC_CHANNELS, N_MELS, VOC_PRE_K), "conv"),
           "generator.0.bias": ((VOC_CHANNELS,), "bias")}
    ch, idx = VOC_CHANNELS, 2
    for i, r in enumerate(VOC_RATIOS):
        c = VOC_CHANNELS >> (i + 1)
        out[f"generator.{idx}.layer.weight"] = ((ch, c, 2 * r), "convT")
        out[f"generator.{idx}.layer.bias"] = ((c,), "bias")
        for j in range(len(VOC_DILATIONS)):
            out[f"generator.{idx + 1}.blocks.{j}.2.weight"] = ((c, c, VOC_RES_K), "conv")
            out[f"generator.{idx + 1}.blocks.{j}.2.bias"] = ((c,), "bias")
            out[f"generator.{idx + 1}.blocks.{j}.4.weight"] = ((c, c, 1), "conv")
            out[f"generator.{idx + 1}.blocks.{j}.4.bias"] = ((c,), "bias")
        ch, idx = c, idx + 3
    out[f"generator.{idx}.weight"] = ((1, ch, VOC_POST_K), "conv")
    out[f"generator.{idx}.bias"] = ((1,), "bias")
    return out


# ----------------------------------------------------------------------
# Inference (main.py:96-109)
# ----------------------------------------------------------------------


def trim_center(est: torch.Tensor, n: int) -> torch.Tensor:
    """est [S, L] -> [S, n], centred: est[:, (L - n) // 2 :][:, :n]."""
    start = max(est.shape[-1] - n, 0) // 2
    return est[:, start : start + n]


def infer(wav: torch.Tensor, weights: dict, rnd=identity) -> torch.Tensor:
    """wav [S, n] (the S rows of one utterance) -> [S, n] in wav's dtype.
    weights: {"unet": ..., "vocoder": ...}, float32 on wav's device."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            mel = mel_of(wav, rnd).to(torch.float32)
            log_mel = torch.log10(torch.clamp(mel, min=1e-8))
            out = unet(log_mel, weights["unet"], rnd) + log_mel
            y = vocoder(torch.pow(10.0, torch.clamp(out, max=5.0)), weights["vocoder"], rnd)
            return trim_center(y, wav.shape[-1]).to(wav.dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = matmul, cudnn
