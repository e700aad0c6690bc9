"""NVSR — mel-domain speech super-resolution (reference examples/NVSR/
nvsr_unet.py) as torch modules over the port's own DSP.

Pipeline (reference nvsr_unet.py:71-127, main.py:96-109):
    wav --STFT(2048/441, eps 1e-8)--> |sp| --mel fbanks--> mel
    mel --Generator: analysis(to_log(mel)) + to_log(mel)--> log-mel
    from_log --> vocoder --> wav, trim_center to the input length

Generator variants match the reference's registry (nvsr_unet.py:185-236):
'unet' / 'unet_small' (the UNetRes), 'bigru' (BN -> Linear -> 2-layer
BiGRU -> MLP head), 'dnn' (MLP stack with BN).  to_log clips at 1e-8 and
from_log clips the exponent at +5 (nvsr_unet.py:130-139).

`.eval()` (the testees' mode) reads every BatchNorm's running statistics;
`.train()` is flax's `train=True` (models/train.py): batch statistics, and
running statistics updated as flax updates its `batch_stats`.

On a bucketed batch the testees pass each row's valid frame count
(`frames`, T_j = n_j // 441 + 1) to the generator and the vocoder, and trim
each row about its own T_j * 441 samples (`trim_center(..., est_len)`), so
a row scores as its utterance run alone; without `frames` (training) every
frame of the buffer is valid.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssr_eval_tpu_torch.dsp.spectral import StftConfig, stft_magnitude
from ssr_eval_tpu_torch.models.mel import MelScale
from ssr_eval_tpu_torch.models.unet import FlaxBatchNorm, UNetRes
from ssr_eval_tpu_torch.models.vocoder import HiFiGANVocoder, TFGANConfig, Vocoder

NVSR_STFT = StftConfig(n_fft=2048, hop=441)


def to_log(x):
    return torch.log10(torch.clamp(x, min=1e-8))


def from_log(x):
    return torch.pow(10.0, torch.clamp(x, max=5.0))


class _ScalarBN(FlaxBatchNorm, nn.BatchNorm1d):
    """BatchNorm over one pseudo-channel: every element of [..., F] shares
    one affine (the JAX package's `BatchNorm()(x[..., None])[..., 0]`)."""

    def __init__(self):
        super().__init__(1, momentum=0.01)

    def forward(self, x):
        return super().forward(x.reshape(-1, 1)).reshape(x.shape)


def _zero_rz_grad(grad):
    """bias_hh = (b_hr, b_hz, b_hn): only b_hn exists in flax's cell."""
    h = grad.shape[0] // 3
    return torch.cat([torch.zeros_like(grad[: 2 * h]), grad[2 * h :]])


class BNGRU(nn.Module):
    """BatchNorm over a single pseudo-channel + stacked bidirectional GRU
    (reference nvsr_unet.py:18-58).

    flax's GRUCell has no hidden bias on the r and z gates and its `hn`
    bias is torch's `b_hn`, so `nn.GRU` computes the JAX cell exactly with
    b_hr = b_hz = 0 (models/convert.py writes them so).  A gradient hook
    zeroes their gradient, so training keeps them 0."""

    def __init__(self, in_features: int, hidden: int, layers: int = 2):
        super().__init__()
        self.bn = _ScalarBN()
        self.gru = nn.GRU(in_features, hidden, num_layers=layers, batch_first=True, bidirectional=True)
        for name, p in self.gru.named_parameters():
            if name.startswith("bias_hh"):
                p.register_hook(_zero_rz_grad)

    def forward(self, x, frames=None):
        # x: [B, T, F] -> [B, T, 2 * hidden]; with `frames` each row runs over
        # its own frames only (the backward direction starts at its last)
        # and reads 0 past them.
        h = self.bn(x)
        if frames is None:
            return self.gru(h)[0]
        packed = nn.utils.rnn.pack_padded_sequence(h, frames.cpu(), batch_first=True, enforce_sorted=False)
        return nn.utils.rnn.pad_packed_sequence(self.gru(packed)[0], batch_first=True, total_length=x.shape[1])[0]


class Generator(nn.Module):
    """Residual-in-log-mel-space generator (nvsr_unet.py:185-236)."""

    def __init__(self, model_name: str = "unet", n_mels: int = 128, fold_bn: bool = False):
        super().__init__()
        self.model_name = model_name
        self.fold_bn = fold_bn
        m = n_mels
        if model_name in ("unet", "unet_small"):
            # unet_small's blocks are structurally identical in the reference
            # (components/unet_small.py is a class-rename of unet.py).
            self.analysis_module = UNetRes(channels=1, fold_bn=fold_bn)
        elif model_name == "bigru":
            if fold_bn:
                raise ValueError(
                    "fold_bn supports the unet/unet_small/dnn generators "
                    "(bigru's BNs feed recurrent cells; fold unimplemented)"
                )
            self.bn0 = _ScalarBN()
            self.linear_in = nn.Linear(m, m * 2)
            self.bngru = BNGRU(m * 2, m * 2, layers=2)
            self.linear_mid = nn.Linear(m * 4, m * 2)
            self.linear_out = nn.Linear(m * 2, m)
        elif model_name == "dnn":
            widths = (m, m * 2, m * 4, m * 4)
            for i in range(3):
                setattr(self, f"dense_{i}", nn.Linear(widths[i], widths[i + 1]))
                # bn_i sits directly before dense_{i+1} (relu is BEFORE it),
                # so with fold_bn its scalar affine lives inside the next
                # Linear's weight and bias (models/fold_bn.py).
                if not fold_bn:
                    setattr(self, f"bn_{i}", _ScalarBN())
            self.dense_3 = nn.Linear(m * 4, m * 2)
            self.dense_4 = nn.Linear(m * 2, m)
        else:
            raise ValueError(f"unknown generator {model_name!r}")

    def forward(self, mel_orig, frames=None):
        # mel_orig: [B, T, M] linear-scale mel; frames: None, or each row's
        # valid frames [B] (the dnn is frame by frame and needs none)
        log_mel = to_log(mel_orig)
        if self.model_name in ("unet", "unet_small"):
            out = self.analysis_module(log_mel[:, None], frames)["mel"][:, 0]
        elif self.model_name == "bigru":
            h = self.linear_in(self.bn0(log_mel))
            h = F.relu(self.bngru(h, frames))
            h = F.relu(self.linear_mid(h))
            out = self.linear_out(h)
        else:
            h = log_mel
            for i in range(3):
                h = F.relu(getattr(self, f"dense_{i}")(h))
                if not self.fold_bn:
                    h = getattr(self, f"bn_{i}")(h)
            out = self.dense_4(F.relu(self.dense_3(h)))
        return {"mel": out.to(torch.float32) + log_mel}


class NVSR(nn.Module):
    """Full NVSR: generator + vocoder; `pre` maps wav -> mel.

    vocoder_name "tfgan" is the voicefixer-structure vocoder (reference
    parity; voicefixer state dicts load into it), "hifigan" the JAX
    package's native generator.  `vocoder_cfg` None is the 44.1 kHz preset.
    `fold_bn` builds the inference-only BN-folded generator
    (models/fold_bn.py transforms an unfolded state dict into its shape)."""

    def __init__(
        self,
        model_name: str = "unet",
        n_mels: int = 128,
        sample_rate: int = 44100,
        vocoder_name: str = "tfgan",
        vocoder_cfg: TFGANConfig | None = None,
        fold_bn: bool = False,
    ):
        super().__init__()
        self.config = dict(
            model_name=model_name, n_mels=n_mels, sample_rate=sample_rate, vocoder_name=vocoder_name,
            vocoder_cfg=vocoder_cfg, fold_bn=fold_bn,
        )
        self.model_name = model_name
        self.n_mels = n_mels
        self.sample_rate = sample_rate
        self.vocoder_cfg = vocoder_cfg
        self.fold_bn = fold_bn
        self.generator = Generator(model_name, n_mels, fold_bn=fold_bn)
        if vocoder_name == "tfgan":
            self.vocoder = Vocoder(vocoder_cfg or TFGANConfig(n_mels=n_mels))
        elif vocoder_name == "hifigan":
            self.vocoder = HiFiGANVocoder(n_mels=n_mels)
        else:
            raise ValueError(f"unknown vocoder {vocoder_name!r}")
        self.mel = MelScale(n_mels=n_mels, sample_rate=sample_rate, n_stft=NVSR_STFT.n_bins)

    def clone(self, **overrides):
        """A new NVSR (fresh weights, on the CPU) with this one's
        configuration, `overrides` applied."""
        return NVSR(**{**self.config, **overrides})

    def pre(self, wav, length, max_frames):
        """wav [B, Lmax] (true lengths `length` [B]) -> (sp [B, T, F],
        mel [B, T, M]), T = max_frames.

        The magnitude floor is FDomainHelper's eps=1e-8 power clamp
        (reference dsp.py:72-74 via :83-105); the |STFT| is the port's
        kernel on a card tensor."""
        sp = stft_magnitude(wav, length, NVSR_STFT, max_frames, eps=1e-8)
        return sp, self.mel(sp)

    def forward(self, mel_orig, frames=None):
        return self.generator(mel_orig, frames)

    def synthesize(self, log_mel, frames=None):
        """Denoised log-mel [B, T, M] -> waveform [B, T*hop]; with `frames`
        row j is valid over its first frames[j] * hop samples."""
        return self.vocoder(from_log(log_mel), frames)

    def init_all(self, mel_orig):
        """Generator then vocoder: the call that reaches every submodule
        (the JAX package's `init` traces it; torch builds eagerly)."""
        return self.synthesize(self.generator(mel_orig)["mel"])


def trim_center(est, ref_len, est_len=None):
    """Center-trim each row of est [B, L] to its ref_len [B] (reference
    main.py:22-35): row b keeps est[b, s : s + ref_len[b]] with
    s = max(est_len[b] - ref_len[b], 0) // 2, at the front of an L-long row
    of zeros.  est_len [B] is each row's own output length (None: L, every
    row valid over the whole buffer).  Rows are independent."""
    B, L = est.shape
    ref_len = ref_len.to(torch.int64)
    est_len = L if est_len is None else est_len.to(torch.int64)
    start = torch.clamp(est_len - ref_len, min=0) // 2
    idx = start[:, None] + torch.arange(L, device=est.device)[None, :]
    rolled = torch.gather(est, 1, torch.clamp(idx, max=L - 1))
    keep = (idx < L) & (torch.arange(L, device=est.device)[None, :] < ref_len[:, None])
    return torch.where(keep, rolled, torch.zeros_like(rolled))


_WEIGHTED = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d, nn.Linear)


# flax's lecun_normal: a normal cut at +-2 of its scale, the scale raised
# by 1/std(N(0,1) truncated at +-2) so the draw keeps variance 1/fan_in.
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights drawn as the JAX package's flax defaults draw
    them: every conv, transposed conv, Linear and GRU input weight from
    `lecun_normal` (a normal truncated at +-2s, s = sqrt(1/fan_in)/0.8796,
    so variance 1/fan_in and |w| <= 2.2737/sqrt(fan_in)) with flax's fan_in
    (kernel size x input channels); each of a GRU's recurrent gate blocks
    (r, z, n in `weight_hh_l*`) an orthogonal H x H matrix, as flax's
    `orthogonal()` draws `hr`, `hz` and `hn`; biases 0, BatchNorm identity.
    Drawn on the CPU from one torch.Generator in module order, so a seed
    gives the same weights on any device."""
    g = torch.Generator().manual_seed(int(seed))

    def lecun_normal(w, fan_in):
        s = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
        w.copy_(nn.init.trunc_normal_(torch.empty(w.shape), 0.0, s, -2 * s, 2 * s, generator=g))

    def orthogonal_gates(w):
        h = w.shape[1]
        w.copy_(torch.cat([nn.init.orthogonal_(torch.empty(h, h), generator=g) for _ in range(w.shape[0] // h)]))

    for m in model.modules():
        if isinstance(m, _WEIGHTED):
            w = m.weight
            out_axis = 1 if isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d)) else 0
            lecun_normal(w, w.numel() // w.shape[out_axis])
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GRU):
            for name, p in m.named_parameters():
                if name.startswith("weight_ih"):
                    lecun_normal(p, p.shape[1])
                elif name.startswith("weight_hh"):
                    orthogonal_gates(p)
                else:
                    p.zero_()
        elif isinstance(m, nn.modules.batchnorm._BatchNorm):
            m.reset_parameters()
    return model


# Reference-name alias (nvsr_unet.py:18 exposes BN_GRU).
BN_GRU = BNGRU


def get_n_params(model_or_state):
    """Total parameter count (reference nvsr_unet.py:61-68): the parameters
    of a module, or the leaves of a JAX-style variables tree (its 'params'
    collection when given full variables)."""
    if isinstance(model_or_state, nn.Module):
        return int(sum(p.numel() for p in model_or_state.parameters()))
    tree = model_or_state
    if isinstance(tree, dict) and "params" in tree:
        tree = tree["params"]

    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        return int(np.prod(np.shape(t)))

    return count(tree)
