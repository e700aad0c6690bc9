from ssr_eval_tpu_torch.models.mel import MelScale, melscale_fbanks
from ssr_eval_tpu_torch.models.unet import UNetRes
from ssr_eval_tpu_torch.models.nvsr import NVSR, Generator
from ssr_eval_tpu_torch.models.vocoder import HiFiGANVocoder

__all__ = [
    "MelScale",
    "melscale_fbanks",
    "UNetRes",
    "NVSR",
    "Generator",
    "HiFiGANVocoder",
]
