from ssr_eval_tpu_torch.metrics.kernels import metric_stft_config, spectral_metrics
from ssr_eval_tpu_torch.metrics.audio_metrics import AudioMetrics

__all__ = ["AudioMetrics", "metric_stft_config", "spectral_metrics"]
