"""Small host helpers shared across the package (reference ssr_eval/utils.py
parity: ``dict_mean`` utils.py:24-28, ``write_json`` utils.py:18-21,
``energy_unify`` utils.py:79-92)."""

from __future__ import annotations

import json

import numpy as np

EPS = 1e-12


def dict_mean(dict_list):
    """Key-wise arithmetic mean over a list of dicts of scalars."""
    return {k: float(np.mean([d[k] for d in dict_list])) for k in dict_list[0].keys()}


def pow_p_norm(signal):
    """Squared L2 norm over all dims >= 1, keepdims (reference utils.py:68-76)."""
    return np.sum(signal * signal, axis=tuple(range(1, signal.ndim)), keepdims=True)


def pow_norm(s1, s2):
    """Inner product over dims >= 2, keepdims (reference utils.py:85-92)."""
    return np.sum(s1 * s2, axis=tuple(range(2, s1.ndim)), keepdims=True)


def energy_unify(estimated, original):
    """Rescale `original` onto `estimated`'s energy (reference utils.py:79-82)."""
    target = pow_norm(estimated, original) * original
    target = target / (pow_p_norm(original) + EPS)
    return estimated, target


def write_json(obj, fname):
    with open(fname, "w") as f:
        f.write(json.dumps(obj, indent=4))
