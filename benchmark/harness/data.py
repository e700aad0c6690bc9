"""The benchmark's dataset: a VCTK-layout tree of 16-bit FLAC files.

Signals are a frozen copy of the speech-like generator the repository's
tests use (a harmonic stack on a wandering f0 with formant bumps, breath
noise with a +6 dB/octave tilt, a syllabic envelope), drawn on the device
from one `torch.Generator` seeded with the run's seed, in float64, so the
same seed gives the same samples on the same kind of device.  The speakers,
the files a speaker and their lengths come from the configuration file and
never from the seed.

The tree is written with the program's own FLAC writer (what a user's data
would be: FLAC, as VCTK ships it).  The comparison never reads it back: the
reference takes the int16 samples made here.
"""

from __future__ import annotations

import math
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

FORMANTS = ((500.0, 120.0, 2.0), (1500.0, 200.0, 1.2), (2500.0, 300.0, 0.8))
HARMONICS = 39


def speechlike(n: int, sr: int, g: torch.Generator, device) -> torch.Tensor:
    """One speech-like signal of n samples, float64 in (-1, 1)."""
    f64 = dict(device=device, dtype=torch.float64)
    r = torch.rand(3 + HARMONICS, generator=g, **f64)
    t = torch.arange(n, **f64) / sr
    f0 = 120.0 + 40.0 * torch.sin(2 * math.pi * (0.7 + 0.3 * r[0]) * t) + 20.0 * r[1]
    phase = 2 * math.pi * torch.cumsum(f0, 0) / sr
    h = torch.arange(1, HARMONICS + 1, **f64)
    amp = 1.0 / h
    fh = h * f0.mean()
    for fc, bw, gain in FORMANTS:
        amp = amp * (1.0 + gain * torch.exp(-0.5 * ((fh - fc) / bw) ** 2))
    x = (amp[:, None] * torch.sin(h[:, None] * phase[None, :] + 6.28 * r[3:, None])).sum(0)
    noise = torch.randn(n, generator=g, **f64)
    noise = torch.diff(noise, prepend=noise.new_zeros(1))
    x = x / x.abs().max() * 0.6 + 0.01 * noise / noise.abs().max().clamp(min=1e-9)
    env = 0.55 + 0.45 * torch.sin(2 * math.pi * 3.1 * t + 6.28 * r[2])
    return torch.clamp(x * env, -0.99, 0.99)


def length_stride(grid: int, speakers: int) -> int:
    """The step between the grid indices of one speaker's consecutive files:
    the first integer from grid / 2 + grid / (2 * speakers) up that is
    co-prime with the grid (29 for 48 lengths and 8 speakers)."""
    s = grid // 2 + grid // (2 * speakers)
    while math.gcd(s, grid) != 1:
        s += 1
    return s


def file_plan(config: dict) -> list[tuple[str, str, int]]:
    """-> [(speaker, file name, samples)] in the order they are drawn.

    Speaker k's file i takes the grid length at index
    (k * grid // speakers + i * stride) mod grid, stride co-prime with the
    grid: every speaker holds every length once, and the first n files of
    every speaker (what `evaluate(limit_test_nums=n)` reads, the names
    sorting by i) spread over the whole grid rather than its short end."""
    durs = config["durations_s"]
    sr, G = config["native_sr"], len(durs)
    speakers = config["speakers"]
    stride = length_stride(G, len(speakers))
    out = []
    for k, spk in enumerate(speakers):
        for i in range(config["files_per_speaker"]):
            d = durs[(k * G // len(speakers) + i * stride) % G]
            out.append((spk, f"{spk}_{i:03d}_mic1.flac", int(round(d * sr))))
    return out


def make_pcm(config: dict, seed: int, device) -> dict:
    """-> {(speaker, name): int16 samples} drawn from `seed` on `device`."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    sigs = [speechlike(n, config["native_sr"], g, device) for _, _, n in file_plan(config)]
    pcm = torch.round(torch.cat(sigs) * 32768.0).to(torch.int16).cpu().numpy()
    out, at = {}, 0
    for (spk, name, n) in file_plan(config):
        out[(spk, name)] = pcm[at : at + n]
        at += n
    return out


def write_tree(root: str, pcm: dict, sr: int, write_flac, workers: int = 8) -> str:
    """Write root/<speaker>/<name> for every entry of `pcm`; -> root."""
    for spk in {s for s, _ in pcm}:
        os.makedirs(os.path.join(root, spk), exist_ok=True)

    def one(item):
        (spk, name), x = item
        write_flac(os.path.join(root, spk, name), x.astype(np.float32) / 32768.0, sr)

    with ThreadPoolExecutor(workers) as ex:
        list(ex.map(one, pcm.items()))
    return root
