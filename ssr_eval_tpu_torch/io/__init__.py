from ssr_eval_tpu_torch.io.audio import decode_audio, load, read_wav, write_wav, write_flac

__all__ = ["decode_audio", "load", "read_wav", "write_wav", "write_flac"]
