"""NVSR testees — batched device counterparts of the reference's three
evaluation entry points (examples/NVSR/main.py:96-163):

- `NVSRTestee`:        wav -> |STFT| -> mel -> generator -> vocoder -> trim
- `NVSRPostProcTestee`: + ground-truth low-band splice (BasicTestee.
  postprocessing, reference eval.py:33-41), batched on the device
- `NVSRPaddingPostProcTestee`: generator ablation — tiles the mel row at
  the detected cutoff into all higher bands before vocoding
  (main.py:138-163)

All three implement the BatchedTestee protocol: the engine keeps
degrade -> infer -> metrics on the card.  Weights live in `device_state()`
(one cached structure, uploaded once) and each call runs the generator
and the vocoder with them through `torch.func.functional_call`, the port's
counterpart of the JAX package's `model.apply(state, ...)`.  Every model
call runs under `torch.inference_mode()`: the engine calls `infer_batch`
outside any no-grad scope, and a 65M-parameter forward pass would otherwise
keep every activation.

|STFT| kernel launches per `infer_batch`: 1 (`NVSR.pre`, 2048/441) for
`NVSRTestee`; 2 (+ the cutoff detection at 2048/512) for the two
post-processing testees.
"""

from __future__ import annotations

import contextlib
import os

import torch
import torch.nn.functional as F
from torch.func import functional_call

from ssr_eval_tpu_torch.device import resolve_device
from ssr_eval_tpu_torch.dsp.spectral import (
    StftConfig,
    istft,
    n_frames_for_length,
    stft_magnitude,
    stft_real_imag,
)
from ssr_eval_tpu_torch.harness.testee import BatchedTestee
from ssr_eval_tpu_torch.models.nvsr import NVSR, NVSR_STFT, from_log, init_weights, to_log, trim_center
from ssr_eval_tpu_torch.models.vocoder import TFGANConfig

CKPT_URL = (
    "https://zenodo.org/record/6370601/files/epoch%3D11-step%3D22499-val_l%3D0.27.ckpt"
)
_POSTPROC_STFT = StftConfig(n_fft=2048, hop=512)


def batched_cutoff_index(x, lengths, cfg=_POSTPROC_STFT, threshold=0.97):
    """Device version of BasicTestee._get_cutoff_index (eval.py:28-31):
    largest STFT bin whose cumulative (over bins) summed magnitude is
    below threshold * total.  x: [B, Lmax] -> [B] int32."""
    mf = cfg.max_frames(x.shape[1])
    mag = stft_magnitude(x, lengths, cfg, mf)  # [B, mf, F]
    nf = n_frames_for_length(cfg, lengths.to(torch.int64))
    fmask = (torch.arange(mf, device=x.device)[None, :] < nf[:, None]).to(mag.dtype)
    energy = torch.cumsum(torch.sum(mag * fmask[:, :, None], dim=1), dim=1)  # [B, F]
    below = energy < energy[:, -1:] * threshold
    bins = torch.arange(energy.shape[1], device=x.device)
    idx = torch.where(below, bins[None, :], torch.full_like(bins, -1)[None, :])
    return torch.clamp(idx.max(dim=1).values, min=0).to(torch.int32)


def batched_low_band_splice(x, x_len, out, out_len, cutoff_bins):
    """Device version of BasicTestee.postprocessing (eval.py:33-41):
    replace out's STFT bins below each utterance's cutoff with the
    ground-truth bins, resynthesize at out's length."""
    cfg = _POSTPROC_STFT
    lmax = out.shape[1]
    mf = cfg.max_frames(lmax)
    gr, gi = stft_real_imag(x, x_len, cfg, mf)
    orr, oim = stft_real_imag(out, out_len, cfg, mf)
    low = torch.arange(cfg.n_bins, device=x.device)[None, None, :] < cutoff_bins.to(torch.int64)[:, None, None]
    nf = n_frames_for_length(cfg, out_len.to(torch.int64))
    fmask = (torch.arange(mf, device=x.device)[None, :] < nf[:, None]).to(gr.dtype)[:, :, None]
    real = torch.where(low, gr, orr) * fmask
    imag = torch.where(low, gi, oim) * fmask
    return istft(real, imag, out_len, cfg, lmax)


class NVSRTestee(BatchedTestee):
    """Generator + vocoder inference (reference main.py:96-109).

    model_name: 'unet' (the 65M UNet; 'unet_small' is the same), 'bigru'
    or 'dnn'.  Weights, in order of precedence: `ckpt` (a reference torch
    NVSR checkpoint, `load_checkpoint`), `params` (the JAX package's
    variables tree as NumPy arrays, carried by
    `convert.nvsr_state_from_flax`), else seeded random weights
    (`nvsr.init_weights(seed)`).
    dtype: model compute dtype; torch.bfloat16 runs the generator and the
    vocoder under a bfloat16 autocast (the evaluation DSP and the mel stay
    float32).  None is float32 with no TF32.
    param_dtype: every parameter in `device_state()` is rounded to it,
    BatchNorm's scale and bias included (the JAX package rounds its whole
    `params` collection); the running statistics stay float32.  The
    conv / Linear / GRU weights are stored in it when dtype is bfloat16;
    with dtype None they, and BatchNorm's affine always (torch's
    batch_norm takes it in the statistics' dtype), go back to float32
    after rounding (the JAX package's promotion).
    fold_bn: fold eval-mode BatchNorms into adjacent convs / Linears where
    exact (models/fold_bn.py) — inference only.
    device: None is the CUDA card (raises without one), "cpu" the CPU.
    """

    def __init__(self, model_name="unet", params=None, seed=234, ckpt=None, dtype=None,
                 param_dtype=None, fold_bn=False, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if dtype not in (None, torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be None, torch.float32 or torch.bfloat16, got {dtype}")
        self.dtype = None if dtype == torch.float32 else dtype
        self.param_dtype = param_dtype
        self.fold_bn = fold_bn
        base = NVSR(model_name=model_name)
        if ckpt is None and params is not None:
            from ssr_eval_tpu_torch.models.convert import nvsr_state_from_flax

            base.load_state_dict(nvsr_state_from_flax(params))
        elif ckpt is None:
            init_weights(base, seed)
        self._set_base(base)
        if ckpt is not None:
            self.load_checkpoint(ckpt)

    # -- weights -------------------------------------------------------

    def _set_base(self, base):
        """Install an unfolded NVSR as the source of the weights; `model`
        is the module that runs (folded when fold_bn)."""
        from ssr_eval_tpu_torch.models.fold_bn import fold_nvsr_bn

        self._base = base.to(self.device).eval()
        self.model = fold_nvsr_bn(self._base) if self.fold_bn else self._base
        self._dev_state = None

    def device_state(self):
        """The model's weights on the testee's device: {"generator": ...,
        "vocoder": ...}, each the submodule's parameters and buffers by
        name.  Built once and returned as the same object on every call,
        so the engine copies it once."""
        if self._dev_state is None:
            state = {}
            for sub in ("generator", "vocoder"):
                mod = getattr(self.model, sub)
                tensors = {k: v.detach() for k, v in mod.named_buffers()}
                for mname, m in mod.named_modules():
                    for pname, p in m.named_parameters(recurse=False):
                        key = f"{mname}.{pname}" if mname else pname
                        p = p.detach()
                        if self.param_dtype is not None:
                            p = p.to(self.param_dtype)
                            if self.dtype is None or isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                                p = p.to(torch.float32)
                        tensors[key] = p
                state[sub] = tensors
            self._dev_state = state
        return self._dev_state

    def load_checkpoint(self, path):
        """Load a reference torch NVSR checkpoint (the Zenodo ckpt,
        main.py:50-79): its `generator.*` entries carry the reference's
        names and layouts, so they load into the generator directly.
        Checkpoints are unfolded; a fold_bn testee folds after loading.
        Entries outside the generator are reported, not loaded; a missing
        generator entry raises."""
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict) and "state_dict" in sd:
            sd = sd["state_dict"]
        gen = {k[len("generator."):]: v for k, v in sd.items() if k.startswith("generator.")}
        missing, unexpected = self._base.generator.load_state_dict(gen, strict=False)
        if missing:
            raise ValueError(f"checkpoint {path} lacks {len(missing)} generator entries: {missing[:5]} ...")
        rest = [k for k in sd if not k.startswith("generator.")] + [f"generator.{k}" for k in unexpected]
        if rest:
            print(f"[convert] {len(rest)} unmatched tensors (e.g. vocoder): {rest[:5]} ...")
        self._set_base(self._base)
        return rest

    def load_generator_checkpoint(self, path):
        """Graft a generator trained by the JAX package (its `.npz`
        variables tree {"params": {"generator": ...}, "batch_stats":
        {"generator": ...}}, e.g. examples/trained_small/generator_dnn.npz)
        into this testee's generator."""
        from ssr_eval_tpu_torch.models.checkpoint import restore_variables
        from ssr_eval_tpu_torch.models.convert import nvsr_state_from_flax

        tree = restore_variables(path)
        sub = {c: {"generator": tree[c]["generator"]} for c in ("params", "batch_stats") if c in tree}
        state = nvsr_state_from_flax(sub)
        self._base.generator.load_state_dict({k[len("generator."):]: v for k, v in state.items()})
        self._set_base(self._base)

    def load_vocoder_checkpoint(self, path, cfg=None, check=True, check_threshold=0.5):
        """Graft a voicefixer-structure vocoder state dict (torch) into the
        model's vocoder (convert.vocoder_state_from_voicefixer).

        With cfg=None the hyperparameters are inferred from the tensor
        shapes (convert.infer_vocoder_config), and the vocoder is rebuilt
        when they differ from the current config.  check=True runs the
        load-time sanity check (models/vocoder_check.py) and raises
        VocoderSanityError when the synthesis does not follow its
        conditioning; random-weight mirrors must pass check=False.
        Returns the list of unmatched tensor names (empty on full match)."""
        from ssr_eval_tpu_torch.models.convert import infer_vocoder_config, vocoder_state_from_voicefixer

        if self._base.config["vocoder_name"] != "tfgan":
            raise ValueError("voicefixer checkpoints load into the 'tfgan' vocoder")
        sd = torch.load(path, map_location="cpu", weights_only=False)
        if isinstance(sd, dict):
            for k in ("state_dict", "generator", "model"):
                if k in sd and isinstance(sd[k], dict):
                    sd = sd[k]
                    break
        if cfg is None:
            cfg = infer_vocoder_config(sd)
        base = self._base
        if cfg != (base.vocoder_cfg or TFGANConfig(n_mels=base.n_mels)):
            rebuilt = base.clone(vocoder_cfg=cfg)
            rebuilt.generator.load_state_dict(base.generator.state_dict())
            base = rebuilt
        state, unmatched = vocoder_state_from_voicefixer(sd, cfg, prefix="")
        base.vocoder.model.load_state_dict(state)
        if unmatched:
            print(f"[convert] vocoder: {len(unmatched)} unmatched tensors: {unmatched[:5]} ...")
        self._set_base(base)
        if check:
            from ssr_eval_tpu_torch.models.vocoder_check import check_vocoder

            check_vocoder(self.model, threshold=check_threshold)
        return unmatched

    # -- the device path -----------------------------------------------

    def _compute(self, device):
        """The model-compute scope: a bfloat16 autocast when dtype asks."""
        if self.dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(device.type, dtype=self.dtype)

    def _mel_of(self, x, lengths):
        """Linear mel [B, T, M] over all max_frames frames of the bucket,
        unmasked, as the JAX package's `_mel_of`."""
        return self.model.pre(x, lengths, NVSR_STFT.max_frames(x.shape[1]))[1]

    def _generate(self, mel, state):
        with self._compute(mel.device):
            out = functional_call(self.model.generator, state["generator"], (mel,))["mel"]
        return out.to(torch.float32)

    def _vocode(self, log_mel, lengths, state):
        with self._compute(log_mel.device):
            wav = functional_call(self.model.vocoder, state["vocoder"], (from_log(log_mel),))
        return trim_center(wav.to(torch.float32), lengths), lengths

    def infer_batch(self, x, lengths, state=None):
        state = state if state is not None else self.device_state()
        with torch.inference_mode():
            mel = self._mel_of(x, lengths)
            return self._vocode(self._generate(mel, state), lengths, state)


def _splice(x, lengths, y, ny):
    """The post-processing testees' low-band splice of y with the input."""
    cut = batched_cutoff_index(x, lengths)
    lmax = max(x.shape[1], y.shape[1])
    xp = F.pad(x, (0, lmax - x.shape[1]))
    yp = F.pad(y, (0, lmax - y.shape[1]))
    return batched_low_band_splice(xp, lengths, yp, ny, cut), ny


class NVSRPostProcTestee(NVSRTestee):
    """+ low-band GT splice after vocoding (reference main.py:112-127)."""

    def infer_batch(self, x, lengths, state=None):
        y, ny = super().infer_batch(x, lengths, state)
        with torch.inference_mode():
            return _splice(x, lengths, y, ny)


class NVSRPaddingPostProcTestee(NVSRTestee):
    """Vocoder-only ablation: tile the mel band at the cutoff upward
    (add_segment_to_higher_freq, main.py:138-151), vocode, then splice."""

    def _tile_mel(self, mel):
        """mel [B, T, M] linear mel.  Cutoff over mel bands by cumulative
        summed energy (get_cutoff_index_v2, main.py:100-102); bands at and
        above it take the cutoff band's values."""
        energy = torch.cumsum(torch.sum(mel, dim=1), dim=1)  # [B, M]
        below = energy < energy[:, -1:] * 0.97
        bands = torch.arange(mel.shape[2], device=mel.device)
        cut = torch.clamp(torch.where(below, bands[None, :], -1).max(dim=1).values, min=0)  # [B]
        row = torch.gather(mel, 2, cut[:, None, None].expand(mel.shape[0], mel.shape[1], 1))
        return torch.where(bands[None, None, :] < cut[:, None, None], mel, row)

    def infer_batch(self, x, lengths, state=None):
        state = state if state is not None else self.device_state()
        with torch.inference_mode():
            tiled = self._tile_mel(self._mel_of(x, lengths))
            y, ny = self._vocode(to_log(tiled), lengths, state)
            return _splice(x, lengths, y, ny)


def download_checkpoint(cache_dir=None):
    """The reference fetches its pretrained checkpoint (main.py:50-79);
    this package never downloads.  Returns the checkpoint's path when it
    is already in `cache_dir`, else raises with where to get it."""
    cache_dir = cache_dir or os.path.join(os.path.expanduser("~"), ".cache", "ssr_eval_tpu_torch", "NVSR")
    path = os.path.join(cache_dir, "epoch=11-step=22499-val_l=0.27.pth")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        f"The NVSR checkpoint is not at {path}, and this package does not "
        f"download it: fetch {CKPT_URL} and pass its path as "
        "NVSRTestee(ckpt=...)."
    )


# Reference name parity (examples/NVSR/main.py:48-93): the base testee's
# responsibilities (checkpoint load, wav->mel pre, device state) all live
# on NVSRTestee here, so the base IS the plain inference testee.
NVSRBaseTestee = NVSRTestee
