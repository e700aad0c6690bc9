"""Pinned reference artifacts for real-data verification.

The port's copy of ``ssr_eval_tpu/harness/golden.py`` (the port imports
nothing of the JAX package; `tests/test_torch_utilities.py` holds every
constant equal to the JAX module's).  `python -m
ssr_eval_tpu_torch.verify_real` reads them.

GOLDEN_2022: the reference's checked-in results artifact
(examples/results/2022-03-28-18:07:54.109221-unprocessed.json, quoted in
reference README.md:33-42) — identity testee, FFT mask, eval at 48 kHz,
the `averaged.proc_fft_24000_44100` block.

NVSR_LEADERBOARD_LSD: the reference README's headline NVSR quality row
(reference README.md:111): per-input-rate LSD evaluated at 44.1 kHz with
the pretrained 99M checkpoint, and the 0.84 average.  Values are quoted
at the README's 2-decimal precision, hence the looser tolerance.
"""

GOLDEN_2022 = {  # "averaged"."proc_fft_24000_44100" in the artifact
    "lsd": 5.152331300436993,
    "log_sispec": 5.8051057146229095,
    "sispec": 30.23394207533686,
    "ssim": 0.8484425044157442,
}
GOLDEN_2022_TOL = {"lsd": 1e-3, "log_sispec": 1e-3, "sispec": 1e-2, "ssim": 1e-3}

# Speakers of the 8-speaker VCTK test tar (plus aggregation blocks) as
# they appear in the artifact's top-level keys.
GOLDEN_2022_SPEAKERS = {
    "p360", "p361", "p362", "p363", "p364", "p374", "p376", "s5",
}

# proc key (after the ctor's cutoff->2*cutoff mapping) -> README LSD.
# The sweep that produces them: setting_fft cutoff_freq
# [1000, 2000, 4000, 6000, 8000, 12000, 16000] at input/output/eval
# 44.1 kHz (reference examples/NVSR/main.py:171 runs the first six;
# 16000 adds the table's 32 kHz column).
NVSR_LEADERBOARD_LSD = {
    "proc_fft_2000_44100": 1.04,
    "proc_fft_4000_44100": 0.98,
    "proc_fft_8000_44100": 0.91,
    "proc_fft_12000_44100": 0.85,
    "proc_fft_16000_44100": 0.79,
    "proc_fft_24000_44100": 0.70,
    "proc_fft_32000_44100": 0.60,
}
NVSR_LEADERBOARD_AVG = 0.84
# README values are 2-decimal; allow rounding + the documented
# GT-resampler deviation (PARITY.md deviation 2).
NVSR_LEADERBOARD_TOL = 0.05
