"""The `nvsr_unet_fp32` testee in plain PyTorch: NVSR at its published
widths (`nvsr_plain.py`), run on each utterance alone, with the weights
that the benchmark draws for the run and hands to both sides."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nvsr_plain

# flax's lecun_normal, as the program's `nvsr.init_weights` draws it: a
# normal cut at +-2 of its scale, the scale raised by 1/std(N(0, 1) cut at
# +-2), so the draw keeps variance 1/fan_in.
TRUNC_STD = 0.87962566103423978


def _check(config: dict) -> None:
    """The configuration's widths are the ones nvsr_plain builds."""
    want = {"unet_widths": list(nvsr_plain.UNET_WIDTHS), "unet_blocks_per_group": nvsr_plain.UNET_BLOCKS,
            "n_mels": nvsr_plain.N_MELS, "n_fft": nvsr_plain.N_FFT, "hop": nvsr_plain.HOP,
            "vocoder_channels": nvsr_plain.VOC_CHANNELS, "vocoder_ratios": list(nvsr_plain.VOC_RATIOS),
            "vocoder_dilations": list(nvsr_plain.VOC_DILATIONS)}
    got = {k: config[k] for k in want}
    if got != want:
        raise ValueError(f"configuration {got} is not the published NVSR {want}")


def _lecun_normal(rng, shape, fan_in):
    z = rng.standard_normal(int(np.prod(shape)), dtype=np.float32)
    while True:
        out = np.abs(z) > 2.0
        if not out.any():
            break
        z[out] = rng.standard_normal(int(out.sum()), dtype=np.float32)
    return (z * np.float32((1.0 / fan_in) ** 0.5 / TRUNC_STD)).reshape(shape)


def _draw(rng, layout: dict) -> dict:
    """Every conv and transposed-conv weight from lecun_normal (fan_in:
    input channels x kernel taps), biases 0, BatchNorm identity."""
    out = {}
    for name, (shape, kind) in layout.items():
        if kind in ("conv", "convT"):
            out_axis = 1 if kind == "convT" else 0
            out[name] = _lecun_normal(rng, shape, int(np.prod(shape)) // shape[out_axis])
        elif kind in ("bn_weight", "bn_var"):
            out[name] = np.ones(shape, np.float32)
        elif kind == "bn_count":
            out[name] = np.zeros(shape, np.int64)
        else:
            out[name] = np.zeros(shape, np.float32)
    return out


def inputs(config: dict, seed: int) -> dict:
    """{"unet": the UNet's state dict (`generator.analysis_module.*`),
    "vocoder": the vocoder's (voicefixer names)}, NumPy arrays drawn from
    the seed in layout order."""
    _check(config)
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    return {"unet": _draw(rng, nvsr_plain.unet_layout()), "vocoder": _draw(rng, nvsr_plain.vocoder_layout())}


def build(config: dict, inputs: dict, device):
    """-> testee(degraded [S, L], rnd) -> [S, L] in the input's dtype."""
    _check(config)
    weights = {part: {k: torch.from_numpy(v).to(device) for k, v in sd.items()} for part, sd in inputs.items()}

    def testee(d: torch.Tensor, rnd) -> torch.Tensor:
        return nvsr_plain.infer(d, weights, rnd)

    return testee
