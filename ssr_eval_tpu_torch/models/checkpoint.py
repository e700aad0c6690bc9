"""Model-weight checkpoints in the JAX package's single-file `.npz` format.

A variables tree (nested dicts of arrays, e.g. {"params": ...,
"batch_stats": ...}) is stored flat under "/"-joined paths, the layout of
the JAX package's `save_variables_npz`, so its checkpoints (e.g.
examples/trained_small/generator_dnn.npz) load here and ours load there.
Orbax checkpoint directories need JAX and are refused with a message.

    save_variables_npz(path, variables)   # or save_variables: the same file
    variables = restore_variables(path)
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _as_np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, p))
        else:
            out[p] = _as_np(v)
    return out


def _unflatten(flat):
    tree = {}
    for path, v in flat.items():
        node = tree
        parts = path.split("/")
        for k in parts[:-1]:
            node = node.setdefault(k, {})
        node[parts[-1]] = v
    return tree


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_variables_npz(path: str, variables) -> str:
    """Write a variables tree as one `.npz` (suffix added if missing) and
    return its path: the JAX package's portable single-file format."""
    p = _npz_path(path)
    np.savez(p, **_flatten(variables))
    return p


def save_variables(path: str, variables) -> str:
    """`save_variables_npz`: the port has no Orbax, so the JAX package's
    Orbax-first `save_variables` always takes its `.npz` branch here."""
    return save_variables_npz(path, variables)


def restore_variables(path: str):
    """Read a `.npz` variables tree (a path with or without the suffix)."""
    if os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an Orbax checkpoint): reading it needs JAX. "
            "Convert it once with the JAX package "
            "(ssr_eval_tpu.models.checkpoint.save_variables_npz) and pass the .npz."
        )
    with np.load(_npz_path(path)) as z:
        return _unflatten({k: z[k] for k in z.files})
