"""Small numeric / IO helpers shared across the package.

Functional parity targets (reference ssr_eval/utils.py), the same names as
``ssr_eval_tpu.utils.common``:
- ``to_log`` / ``from_log``        (utils.py:43-49) — log10(x+1e-12), 10^clip(x,max=5)
- ``dict_mean``                    (utils.py:24-28) — key-wise mean over a list of dicts
- ``write_json`` / ``load_json``   (utils.py:18-21, 31-34)
- ``get_framesLength`` / ``get_sample_rate`` (utils.py:12-15, 37-40) — WAV header readers
- ``write_list`` / ``read_list``   (utils.py:52-65)
- ``pow_p_norm`` / ``pow_norm`` / ``energy_unify`` (utils.py:68-92)

`to_log`, `from_log` and the norms take NumPy arrays or torch tensors and
return the same kind (the JAX package's take NumPy or jax.numpy arrays).
"""

from __future__ import annotations

import json
import wave

import numpy as np
import torch

# Matches the epsilon used throughout the reference (utils.py:7, metrics.py:12).
EPS = 1e-12


def to_log(x):
    """log10(x + 1e-12); works on numpy arrays and torch tensors."""
    if isinstance(x, torch.Tensor):
        return torch.log10(x + EPS)
    return np.log10(x + EPS)


def from_log(x):
    """10 ** min(x, 5); inverse of `to_log` with the reference's +5 clip."""
    if isinstance(x, torch.Tensor):
        return torch.pow(10.0, torch.clamp(x, max=5))
    return np.power(10.0, np.clip(x, a_min=None, a_max=5))


def _sum(x, axes):
    if isinstance(x, torch.Tensor):
        return torch.sum(x, dim=axes, keepdim=True)
    return np.sum(x, axis=axes, keepdims=True)


def dict_mean(dict_list):
    """Key-wise arithmetic mean over a list of dicts of scalars."""
    return {k: float(np.mean([d[k] for d in dict_list])) for k in dict_list[0].keys()}


def write_json(obj, fname):
    with open(fname, "w") as f:
        f.write(json.dumps(obj, indent=4))


def load_json(fname):
    with open(fname, "r") as f:
        return json.load(f)


def get_framesLength(fname):
    """Frame count from a WAV header (reference utils.py:12-15)."""
    with wave.open(fname) as f:
        return f.getparams()[3]


def get_sample_rate(fname):
    """Sample rate from a WAV header (reference utils.py:37-40)."""
    with wave.open(fname) as f:
        return f.getparams()[2]


def pow_p_norm(signal):
    """Squared L2 norm over all dims >= 1, keepdims (reference utils.py:68-76)."""
    return _sum(signal * signal, tuple(range(1, signal.ndim)))


def pow_norm(s1, s2):
    """Inner product over dims >= 2, keepdims (reference utils.py:85-92)."""
    return _sum(s1 * s2, tuple(range(2, s1.ndim)))


def energy_unify(estimated, original):
    """Rescale `original` onto `estimated`'s energy (reference utils.py:79-82)."""
    target = pow_norm(estimated, original) * original
    target = target / (pow_p_norm(original) + EPS)
    return estimated, target


def write_list(items, fname):
    with open(fname, "w") as f:
        for it in items:
            f.write(f"{it}\n")


def read_list(fname):
    with open(fname, "r") as f:
        return [line.rstrip("\n") for line in f.readlines()]
