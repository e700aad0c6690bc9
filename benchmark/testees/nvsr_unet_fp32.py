"""The `nvsr_unet_fp32` testee: the program's `NVSRTestee("unet")` at its
published widths, in float32 with TF32 off, with the weights the benchmark
drew for the run (`reference/nvsr_unet_fp32.py::inputs`), written as the
reference's checkpoint files and read through the program's own loaders:
the UNet as the Zenodo checkpoint's `generator.analysis_module.*` entries
(`NVSRTestee(ckpt=...)`), the vocoder as a voicefixer state dict
(`load_vocoder_checkpoint`; random weights do not pass its synthesis
check, so it is off)."""

from __future__ import annotations

import os

import torch

from ssr_eval_tpu_torch.models.testees import NVSRTestee


def build(config: dict, inputs: dict, device, workdir: str):
    unet = os.path.join(workdir, "nvsr_unet.ckpt")
    vocoder = os.path.join(workdir, "nvsr_vocoder.pt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in inputs["unet"].items()}}, unet)
    torch.save({k: torch.from_numpy(v) for k, v in inputs["vocoder"].items()}, vocoder)
    testee = NVSRTestee(model_name=config["model"], ckpt=unet, device=None if device == "cuda" else device)
    testee.load_vocoder_checkpoint(vocoder, check=False)
    return testee
