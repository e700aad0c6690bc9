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

Modules are inference modules: call `.eval()` (the testees do), so every
BatchNorm reads its running statistics.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ssr_eval_tpu_torch.dsp.spectral import StftConfig, stft_magnitude
from ssr_eval_tpu_torch.models.mel import MelScale
from ssr_eval_tpu_torch.models.unet import UNetRes
from ssr_eval_tpu_torch.models.vocoder import HiFiGANVocoder, TFGANConfig, Vocoder

NVSR_STFT = StftConfig(n_fft=2048, hop=441)


def to_log(x):
    return torch.log10(torch.clamp(x, min=1e-8))


def from_log(x):
    return torch.pow(10.0, torch.clamp(x, max=5.0))


class _ScalarBN(nn.BatchNorm1d):
    """BatchNorm over one pseudo-channel: every element of [..., F] shares
    one affine (the JAX package's `BatchNorm()(x[..., None])[..., 0]`)."""

    def __init__(self):
        super().__init__(1)

    def forward(self, x):
        return super().forward(x.reshape(-1, 1)).reshape(x.shape)


class BNGRU(nn.Module):
    """BatchNorm over a single pseudo-channel + stacked bidirectional GRU
    (reference nvsr_unet.py:18-58).

    flax's GRUCell has no hidden bias on the r and z gates and its `hn`
    bias is torch's `b_hn`, so `nn.GRU` computes the JAX cell exactly with
    b_hr = b_hz = 0 (models/convert.py writes them so)."""

    def __init__(self, in_features: int, hidden: int, layers: int = 2):
        super().__init__()
        self.bn = _ScalarBN()
        self.gru = nn.GRU(in_features, hidden, num_layers=layers, batch_first=True, bidirectional=True)

    def forward(self, x):
        # x: [B, T, F] -> [B, T, 2 * hidden]
        return self.gru(self.bn(x))[0]


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

    def forward(self, mel_orig):
        # mel_orig: [B, T, M] linear-scale mel
        log_mel = to_log(mel_orig)
        if self.model_name in ("unet", "unet_small"):
            out = self.analysis_module(log_mel[:, None])["mel"][:, 0]
        elif self.model_name == "bigru":
            h = self.linear_in(self.bn0(log_mel))
            h = F.relu(self.bngru(h))
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

    def forward(self, mel_orig):
        return self.generator(mel_orig)

    def synthesize(self, log_mel):
        """Denoised log-mel [B, T, M] -> waveform [B, T*hop]."""
        return self.vocoder(from_log(log_mel))

    def init_all(self, mel_orig):
        """Generator then vocoder: the call that reaches every submodule
        (the JAX package's `init` traces it; torch builds eagerly)."""
        return self.synthesize(self.generator(mel_orig)["mel"])


def trim_center(est, ref_len):
    """Center-trim each row of est [B, L] to its ref_len [B] (reference
    main.py:22-35): row b keeps est[b, s : s + ref_len[b]] with
    s = max(L - ref_len[b], 0) // 2, at the front of an L-long row of
    zeros.  Rows are independent."""
    B, L = est.shape
    ref_len = ref_len.to(torch.int64)
    start = torch.clamp(L - ref_len, min=0) // 2
    idx = start[:, None] + torch.arange(L, device=est.device)[None, :]
    rolled = torch.gather(est, 1, torch.clamp(idx, max=L - 1))
    keep = (idx < L) & (torch.arange(L, device=est.device)[None, :] < ref_len[:, None])
    return torch.where(keep, rolled, torch.zeros_like(rolled))


_WEIGHTED = (nn.Conv1d, nn.Conv2d, nn.ConvTranspose1d, nn.ConvTranspose2d, nn.Linear)


@torch.no_grad()
def init_weights(model: nn.Module, seed: int) -> nn.Module:
    """Seeded random weights, the JAX package's initializer family: every
    conv, transposed conv, Linear and GRU weight ~ N(0, 1/fan_in) with
    flax's fan_in (kernel size x input channels), biases 0, BatchNorm
    identity.  Drawn on the CPU from one torch.Generator in module order,
    so a seed gives the same weights on any device."""
    g = torch.Generator().manual_seed(int(seed))

    def normal(w, fan_in):
        w.copy_(torch.randn(w.shape, generator=g) / fan_in ** 0.5)

    for m in model.modules():
        if isinstance(m, _WEIGHTED):
            w = m.weight
            out_axis = 1 if isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d)) else 0
            normal(w, w.numel() // w.shape[out_axis])
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.GRU):
            for name, p in m.named_parameters():
                if name.startswith("weight"):
                    normal(p, p.shape[1])
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
