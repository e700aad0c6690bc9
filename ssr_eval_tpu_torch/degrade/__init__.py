from ssr_eval_tpu_torch.degrade.plan import DegradationSpec, expand_settings
from ssr_eval_tpu_torch.degrade.apply import build_degrader
from ssr_eval_tpu_torch.degrade.lowpass import lowpass, bandpass

__all__ = ["DegradationSpec", "expand_settings", "build_degrader", "lowpass", "bandpass"]
