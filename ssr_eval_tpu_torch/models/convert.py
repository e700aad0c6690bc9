"""Weights into the port's NVSR modules.

- `nvsr_state_from_flax(variables)`: the JAX package's variables tree
  (nested dicts of arrays: `params` + `batch_stats`, as `np.asarray` of its
  device state or an `.npz` restored by models/checkpoint.py) -> the port's
  `state_dict`.  Every leaf is used and every entry of the port's state dict
  is produced (num_batches_tracked as 0); an unknown leaf raises.

    flax Conv kernel        HWIO / (K, I, O)  -> OIHW / (O, I, K)
    flax ConvTranspose      flipped HWIO      -> torch (I, O, kh, kw), un-flipped
                            (`decoder_block{i}.conv1` and the vocoders' `up_i`)
    flax Dense kernel       (in, out)         -> Linear weight (out, in)
    BatchNorm               scale / bias / mean / var
                                              -> weight / bias / running_mean / running_var
    GRUCell_{2l + d}        ir, iz, in, hr, hz, hn
                                              -> nn.GRU layer l (d = 1: `_reverse`),
                                                 b_hr = b_hz = 0

- `flax_from_nvsr_state(state_dict)`: the exact inverse, the port's state
  dict -> the JAX package's variables tree (what `NVSRTrainer` checkpoints;
  b_hr = b_hz must be 0 and are dropped, num_batches_tracked is dropped).
- A reference NVSR state dict (`generator.analysis_module.…`) needs no
  conversion: the port's UNet carries the reference's names and layouts,
  so it loads with `load_state_dict`.
- voicefixer-structure vocoder state dicts (weight-normed Conv1d /
  ConvTranspose1d in a Sequential) map onto `Vocoder` by
  `vocoder_state_from_voicefixer`, weight norm fused; the name map is
  derived from the config (`vocoder_name_map`), and the config itself from
  the tensor shapes (`infer_vocoder_config`); `voicefixer_state_from_vocoder`
  writes a `Vocoder` back in that layout (plain `weight` / `bias`).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from ssr_eval_tpu_torch.models.vocoder import TFGANConfig


def _to_np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


# ----------------------------------------------------------------------
# JAX variables tree -> port state dict
# ----------------------------------------------------------------------


def _is_transposed(path) -> bool:
    """Transposed convs of the NVSR family, by module path."""
    name = path[-1]
    return name.startswith("up_") or (
        name == "conv1" and len(path) > 1 and path[-2].startswith("decoder_block")
    )


def _kernel(path, k):
    if k.ndim == 2:  # Dense (in, out) -> Linear (out, in)
        return k.T
    if k.ndim == 3:  # (K, I, O)
        return k[::-1].transpose(1, 2, 0) if _is_transposed(path) else k.transpose(2, 1, 0)
    if k.ndim == 4:  # (kh, kw, I, O)
        return k[::-1, ::-1].transpose(2, 3, 0, 1) if _is_transposed(path) else k.transpose(3, 2, 0, 1)
    raise ValueError(f"kernel of rank {k.ndim} at {'/'.join(path)}")


def _gru_cells(path, node, out):
    """GRUCell_{2l + d} -> nn.GRU entries under `<path>.gru` (flax creates
    layer l's forward cell, then its backward cell)."""
    for name, cell in node.items():
        m = re.fullmatch(r"GRUCell_(\d+)", name)
        if m is None:
            raise ValueError(f"unexpected entry {name!r} beside the GRU cells at {'/'.join(path)}")
        layer, rev = divmod(int(m.group(1)), 2)
        sfx = f"_l{layer}" + ("_reverse" if rev else "")
        g = {k: {kk: np.asarray(vv) for kk, vv in v.items()} for k, v in cell.items()}
        hidden = g["hr"]["kernel"].shape[1]
        pre = ".".join(path + ["gru"])
        out[f"{pre}.weight_ih{sfx}"] = np.concatenate([g[k]["kernel"].T for k in ("ir", "iz", "in")])
        out[f"{pre}.weight_hh{sfx}"] = np.concatenate([g[k]["kernel"].T for k in ("hr", "hz", "hn")])
        out[f"{pre}.bias_ih{sfx}"] = np.concatenate([g[k]["bias"] for k in ("ir", "iz", "in")])
        out[f"{pre}.bias_hh{sfx}"] = np.concatenate(
            [np.zeros(2 * hidden, g["hn"]["bias"].dtype), g["hn"]["bias"]]
        )
        if set(g) != {"ir", "iz", "in", "hr", "hz", "hn"} or "bias" in g["hr"] or "bias" in g["hz"]:
            raise ValueError(f"{'/'.join(path + [name])} is not a flax GRUCell")


def _walk_params(node, path, out):
    if "kernel" in node or "scale" in node:
        pre = ".".join(path)
        for leaf, v in node.items():
            v = np.asarray(v)
            if leaf == "kernel":
                out[f"{pre}.weight"] = _kernel(path, v)
            elif leaf == "scale":
                out[f"{pre}.weight"] = v
            elif leaf == "bias":
                out[f"{pre}.bias"] = v
            else:
                raise ValueError(f"unknown leaf {'/'.join(path + [leaf])}")
        return
    gru = {k: v for k, v in node.items() if k.startswith("GRUCell_")}
    if gru:
        _gru_cells(path, gru, out)
    for k, v in node.items():
        if k.startswith("GRUCell_"):
            continue
        if not isinstance(v, dict):
            raise ValueError(f"unknown leaf {'/'.join(path + [k])}")
        _walk_params(v, path + [k], out)


def _walk_stats(node, path, out):
    if "mean" in node or "var" in node:
        pre = ".".join(path)
        if set(node) != {"mean", "var"}:
            raise ValueError(f"unknown batch_stats leaves at {'/'.join(path)}: {sorted(node)}")
        out[f"{pre}.running_mean"] = np.asarray(node["mean"])
        out[f"{pre}.running_var"] = np.asarray(node["var"])
        out[f"{pre}.num_batches_tracked"] = np.zeros((), np.int64)
        return
    for k, v in node.items():
        if not isinstance(v, dict):
            raise ValueError(f"unknown batch_stats leaf {'/'.join(path + [k])}")
        _walk_stats(v, path + [k], out)


def flax_to_port_arrays(variables) -> dict:
    """The conversion on NumPy arrays: {port state-dict name: array}.
    Transposes and flips are views, so a tree of zero-stride placeholders
    (e.g. `np.broadcast_to` of `jax.eval_shape` shapes) converts without
    allocating its weights."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unknown collections {sorted(unknown)}; expected params / batch_stats")
    out = {}
    _walk_params(variables.get("params", {}), [], out)
    _walk_stats(variables.get("batch_stats", {}), [], out)
    return out


def nvsr_state_from_flax(variables) -> dict:
    """JAX-package variables tree -> the port's state dict (float32 CPU
    tensors; num_batches_tracked int64).  Load it with
    `model.load_state_dict(state)`: strict loading checks that every port
    entry is assigned and nothing is left over."""
    return {
        k: torch.from_numpy(np.array(v, dtype=np.int64 if k.endswith("num_batches_tracked") else np.float32))
        for k, v in flax_to_port_arrays(variables).items()
    }


# ----------------------------------------------------------------------
# port state dict -> JAX variables tree
# ----------------------------------------------------------------------

_GRU_ENTRY = re.compile(r"(.+)\.gru\.(weight_ih|weight_hh|bias_ih|bias_hh)_l(\d+)(_reverse)?")


def _flax_kernel(path, w):
    """Inverse of `_kernel`: a port weight -> the flax kernel."""
    if w.ndim == 2:
        return w.T
    if w.ndim == 3:
        return w.transpose(2, 0, 1)[::-1] if _is_transposed(path) else w.transpose(2, 1, 0)
    if w.ndim == 4:
        return w.transpose(2, 3, 0, 1)[::-1, ::-1] if _is_transposed(path) else w.transpose(2, 3, 1, 0)
    raise ValueError(f"weight of rank {w.ndim} at {'.'.join(path)}")


def _put(tree, path, leaf, value):
    node = tree
    for k in path:
        node = node.setdefault(k, {})
    node[leaf] = np.ascontiguousarray(value, dtype=np.float32)


def flax_from_nvsr_state(state_dict) -> dict:
    """The port's state dict (tensors or arrays) -> the JAX package's
    variables tree {"params": ..., "batch_stats": ...} of float32 NumPy
    arrays: the exact inverse of `nvsr_state_from_flax`.  A GRU's b_hr and
    b_hz have no flax counterpart and must be 0 (BNGRU keeps them so);
    num_batches_tracked is dropped."""
    sd = {k: _to_np(v) for k, v in state_dict.items()}
    bns = {k[: -len(".running_mean")] for k in sd if k.endswith(".running_mean")}
    params, stats = {}, {}
    for key, v in sd.items():
        pre, leaf = key.rsplit(".", 1)
        path = pre.split(".")
        m = _GRU_ENTRY.fullmatch(key)
        if m is not None:
            node, kind, layer, rev = m.groups()
            cell = node.split(".") + [f"GRUCell_{2 * int(layer) + (rev is not None)}"]
            gates = ("ir", "iz", "in") if kind.endswith("_ih") else ("hr", "hz", "hn")
            for gate, part in zip(gates, np.split(v, 3)):
                if kind.startswith("weight"):
                    _put(params, cell + [gate], "kernel", part.T)
                elif gate in ("hr", "hz"):
                    if np.any(part):
                        raise ValueError(f"{key}: b_{gate} is not 0; flax's GRUCell has no such bias")
                else:
                    _put(params, cell + [gate], "bias", part)
        elif pre in bns:
            if leaf in ("running_mean", "running_var"):
                _put(stats, path, "mean" if leaf == "running_mean" else "var", v)
            elif leaf in ("weight", "bias"):
                _put(params, path, "scale" if leaf == "weight" else "bias", v)
            elif leaf != "num_batches_tracked":
                raise ValueError(f"unknown BatchNorm entry {key}")
        elif leaf == "weight":
            _put(params, path, "kernel", _flax_kernel(path, v))
        elif leaf == "bias":
            _put(params, path, "bias", v)
        else:
            raise ValueError(f"unknown state entry {key}")
    return {"params": params, "batch_stats": stats}


# ----------------------------------------------------------------------
# voicefixer-structure vocoder state dicts
# ----------------------------------------------------------------------


def fuse_weight_norm(weight_v, weight_g):
    """Fold torch weight_norm (default dim=0) into a plain weight:
    w = g * v / ||v|| with the norm over all dims except 0."""
    v = _to_np(weight_v)
    g = _to_np(weight_g)
    axes = tuple(range(1, v.ndim))
    norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
    return (v * (g / norm)).astype(v.dtype)


def _strip_model_prefix(state_dict):
    return {
        (k[len("model."):] if k.startswith("model.") else k): v
        for k, v in state_dict.items()
    }


def infer_vocoder_config(state_dict):
    """Derive a `TFGANConfig` from a voicefixer-structure generator state
    dict's tensor SHAPES alone:

      n_mels / channels / pre kernel   <- generator.0 conv (O, I, K)
      per-stage ratio                  <- ConvTranspose1d kernel K = 2*r
      per-stage width                  <- ConvTranspose1d out dim
      res-block count / kernel         <- blocks.{j}.2 convs per stage
      post kernel                      <- head conv

    Dilation VALUES leave no trace in shapes; the MelGAN/voicefixer-family
    ladder 3**j is assumed (matches every published member).  Raises
    ValueError when the dict is not a voicefixer-structure generator.
    """
    sd = _strip_model_prefix(state_dict)

    def wshape(prefix):
        for leaf in ("weight_v", "weight"):
            k = f"{prefix}.{leaf}"
            if k in sd:
                return tuple(_to_np(sd[k]).shape)
        return None

    pre = wshape("generator.0")
    if pre is None or len(pre) != 3:
        raise ValueError(
            "not a voicefixer-structure generator state dict "
            "(no generator.0 Conv1d weight)"
        )
    channels, n_mels, pre_kernel = (int(v) for v in pre)

    ratios, widths, res_counts, res_kernel = [], [], [], 3
    idx = 2
    while True:
        up = wshape(f"generator.{idx}.layer")
        if up is None:
            break
        _, o_ch, k = (int(v) for v in up)
        ratios.append(k // 2)
        widths.append(o_ch)
        j = 0
        while (s := wshape(f"generator.{idx + 1}.blocks.{j}.2")) is not None:
            res_kernel = int(s[2])
            j += 1
        res_counts.append(j)
        idx += 3
    post = wshape(f"generator.{idx}")
    if not ratios or post is None:
        raise ValueError(
            "not a voicefixer-structure generator state dict "
            "(no upsample stages / head conv found)"
        )
    if len(set(res_counts)) != 1:
        raise ValueError(f"uneven res-block counts per stage: {res_counts}")
    halving = widths == [channels >> (i + 1) for i in range(len(ratios))]
    return TFGANConfig(
        n_mels=n_mels,
        channels=channels,
        ratios=tuple(ratios),
        res_dilations=tuple(3 ** j for j in range(res_counts[0])),
        stage_channels=None if halving else tuple(widths),
        pre_kernel=pre_kernel,
        post_kernel=int(post[2]),
        res_kernel=res_kernel,
    )


def vocoder_name_map(cfg=None):
    """torch-Sequential prefixes of the voicefixer-structure generator ->
    (module name in models.vocoder.TFGANGenerator, kind).

    Sequential layout: [WNConv1d, LeakyReLU, then per upsample stage i:
    UpsampleNet (ConvTranspose1d under `.layer`), ResStack (dilated/1x1
    conv pairs under `.blocks.{j}.{2,4}`), LeakyReLU, ...,
    WNConv1d head, Tanh]."""
    cfg = cfg or TFGANConfig()
    m = {"generator.0": ("pre", "conv1d")}
    idx = 2
    for i in range(len(cfg.ratios)):
        m[f"generator.{idx}.layer"] = (f"up_{i}", "convT1d")
        for j in range(len(cfg.res_dilations)):
            m[f"generator.{idx + 1}.blocks.{j}.2"] = (f"res_{i}_{j}_d", "conv1d")
            m[f"generator.{idx + 1}.blocks.{j}.4"] = (f"res_{i}_{j}_p", "conv1d")
        idx += 3
    m[f"generator.{idx}"] = ("post", "conv1d")
    return m


def vocoder_state_from_voicefixer(state_dict, cfg=None, prefix="vocoder.model."):
    """voicefixer-structure torch state dict -> entries of the port's
    state dict for `Vocoder` (under `prefix`; the generator lives at
    `vocoder.model` of NVSR).  Keys may carry a leading 'model.'.
    Weight-normed convs (`weight_v`/`weight_g`) are fused; plain `weight`
    passes through.  The port's convs have torch's layouts, so nothing is
    transposed.  -> (state, unmatched_names)."""
    sd = _strip_model_prefix(state_dict)
    out, matched = {}, set()
    for src, (name, _kind) in vocoder_name_map(cfg).items():
        if f"{src}.weight_v" in sd:
            w = fuse_weight_norm(sd[f"{src}.weight_v"], sd[f"{src}.weight_g"])
            matched.update({f"{src}.weight_v", f"{src}.weight_g"})
        elif f"{src}.weight" in sd:
            w = _to_np(sd[f"{src}.weight"])
            matched.add(f"{src}.weight")
        else:
            continue
        out[f"{prefix}{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w, np.float32))
        if f"{src}.bias" in sd:
            out[f"{prefix}{name}.bias"] = torch.from_numpy(np.ascontiguousarray(_to_np(sd[f"{src}.bias"]), np.float32))
            matched.add(f"{src}.bias")
    return out, [k for k in sd if k not in matched]


def voicefixer_state_from_vocoder(model, cfg=None) -> dict:
    """The inverse of `vocoder_state_from_voicefixer`: a port `Vocoder` (or
    its `TFGANGenerator`) -> a voicefixer-structure state dict of plain
    `weight` / `bias` float32 CPU tensors (`generator.<i>...` names, as the
    JAX package's `train_vocoder.export_torch_state_dict` writes).  The
    port's convs keep torch's layouts, so nothing is transposed."""
    gen = getattr(model, "model", model)
    cfg = cfg or gen.cfg
    sd = {}
    for src, (name, _kind) in vocoder_name_map(cfg).items():
        mod = getattr(gen, name)
        sd[f"{src}.weight"] = mod.weight.detach().to("cpu", torch.float32).clone()
        if mod.bias is not None:
            sd[f"{src}.bias"] = mod.bias.detach().to("cpu", torch.float32).clone()
    return sd
