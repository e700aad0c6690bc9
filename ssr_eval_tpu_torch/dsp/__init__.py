from ssr_eval_tpu_torch.dsp.spectral import (
    StftConfig,
    hann_window,
    istft,
    n_frames_for_length,
    stft_magnitude,
    stft_real_imag,
)
from ssr_eval_tpu_torch.dsp.filters import (
    FiltFiltPlan,
    design_bandpass_sos,
    design_lowpass_sos,
    make_filtfilt_plan,
    plan_device_arrays,
    sosfiltfilt,
)
from ssr_eval_tpu_torch.dsp.resample import ResamplePlan, apply_resample, resample_poly_plan
from ssr_eval_tpu_torch.dsp.resample import windowed_sinc_plan
from ssr_eval_tpu_torch.dsp.correlate import cross_correlate_full
from ssr_eval_tpu_torch.dsp.fdomain import FDomainHelper

__all__ = [
    "StftConfig",
    "hann_window",
    "istft",
    "n_frames_for_length",
    "stft_magnitude",
    "stft_real_imag",
    "design_lowpass_sos",
    "design_bandpass_sos",
    "sosfiltfilt",
    "ResamplePlan",
    "resample_poly_plan",
    "apply_resample",
    "cross_correlate_full",
    "windowed_sinc_plan",
    "FDomainHelper",
]
