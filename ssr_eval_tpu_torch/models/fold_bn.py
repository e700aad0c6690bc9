"""Inference-time BatchNorm folding for the NVSR model family.

In this pre-activation architecture (reference
examples/NVSR/components/unet.py:289-352) most BNs feed a nonlinearity and
cannot fold, but two adjacencies are exact:

- `conv1 -> bn2` inside every ConvBlockRes (conv directly followed by BN):
  bn2's per-channel affine folds backward into conv1's weight and a new
  bias.  Removes 1 of the 2 BNs in all 50 residual blocks of the 'unet'
  generator.
- the dnn generator's `bn_i -> dense_{i+1}` (BN directly followed by a
  linear op; the relu sits BEFORE bn_i): the scalar pseudo-channel affine
  folds forward into the next Linear.  Removes all 3.

bn1-style BNs (BN -> leaky_relu -> conv) stay.  bigru's BNs feed recurrent
cells and are out of scope (raises).

Eval-mode BN is y = a*x + b with a = weight/sqrt(var+eps),
b = bias - a*mean, computed in float64 with flax's eps 1e-5 (the JAX
package's `fold_bn._BN_EPS`, also torch's BatchNorm default):

  backward into a preceding conv (OIHW, out axis first):
      W' = W * a[:, None, None, None],   bias' = b
  forward into a following Linear (scalar a, b; weight (out, in)):
      W' = a * W,                        bias' = bias + b * W.sum(axis=1)
"""

from __future__ import annotations

import re

import torch

_BN_EPS = 1e-5
_BN_ENTRIES = ("weight", "bias", "running_mean", "running_var", "num_batches_tracked")


def _affine(state, bn):
    """Eval-mode BN `bn` (a state-dict prefix ending in '.') as (a, b)."""
    w, b, mean, var = (state[bn + k].to(torch.float64) for k in _BN_ENTRIES[:4])
    a = w / torch.sqrt(var + _BN_EPS)
    return a, b - a * mean


def _drop_bn(state, bn):
    for k in _BN_ENTRIES:
        state.pop(bn + k, None)


def fold_state_dict(state, model_name: str = "unet"):
    """An unfolded state dict (of NVSR, Generator or UNetRes) -> the folded
    module's state dict.  Entries outside the folded pairs pass through."""
    out = dict(state)
    if model_name in ("unet", "unet_small"):
        for key in [k for k in state if k.endswith("bn2.weight")]:
            blk = key[: -len("bn2.weight")]
            if blk + "conv1.weight" not in state:
                continue
            a, b = _affine(state, blk + "bn2.")
            w = state[blk + "conv1.weight"]
            out[blk + "conv1.weight"] = (w.to(torch.float64) * a[:, None, None, None]).to(w.dtype)
            out[blk + "conv1.bias"] = b.to(w.dtype)
            _drop_bn(out, blk + "bn2.")
    elif model_name == "dnn":
        for key in [k for k in state if re.search(r"(^|\.)bn_\d+\.weight$", k)]:
            bn = key[: -len("weight")]
            i = int(re.search(r"bn_(\d+)\.$", bn).group(1))
            nxt = bn[: -len(f"bn_{i}.")] + f"dense_{i + 1}."
            a, b = _affine(state, bn)
            a, b = float(a[0]), float(b[0])
            w = state[nxt + "weight"]
            w64 = w.to(torch.float64)
            out[nxt + "weight"] = (a * w64).to(w.dtype)
            out[nxt + "bias"] = (state[nxt + "bias"].to(torch.float64) + b * w64.sum(dim=1)).to(w.dtype)
            _drop_bn(out, bn)
    else:
        raise ValueError(f"fold_bn unsupported for generator {model_name!r}")
    return out


def fold_nvsr_bn(model):
    """NVSR (fold_bn=False, eval) -> a new NVSR with fold_bn=True holding
    the folded weights, on the same device.  The vocoder passes through."""
    if model.fold_bn:
        return model
    state = fold_state_dict(model.state_dict(), model.model_name)
    dev = next(model.parameters()).device
    folded = model.clone(fold_bn=True).to(dev)
    folded.load_state_dict(state)
    return folded.eval()
