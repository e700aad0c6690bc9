#!/usr/bin/env python3
"""chip_smoke.py's two checks that read seeded random weights, re-read on
the card across seeds and two draws, beside float64 references and
controls that must fail them.

    python3 chip_probes/init_checks.py [--grads] [SEED ...]   # from the repository root, one card

--grads reads the gradients (2) alone.

Draws: "port" is `nvsr.init_weights` (flax's truncated LeCun normal);
"untruncated" redraws every conv / transposed conv / Linear weight from
N(0, 1/fan_in) (the draw `init_weights` made before it followed flax; the
UNet and the TFGAN vocoder hold no GRU, so this is that draw in full).

1. bf16 against fp32 (chip_smoke.nvsr_bf16_vs_fp32, the `nvsr` phase's
   comparison): for each draw and seed (default NVSR_SEED and 0-5), the
   full-width NVSRTestee("unet") in fp32 through the helper on the sweep's
   data, then in bf16 against it: the max per-pair |bf16 - fp32| of the
   four metrics and of log-SiSpec's |cos t|, the limits of NVSR_BF16 it
   exceeds, and the fp32 log-SiSpec range over the pairs.  Controls: the
   port's NVSR_SEED weights with every mantissa rounded to CONTROL_BITS
   bits, run in bf16, against the unrounded fp32 run.
2. Gradients (chip_smoke.gradient_case, the `train` phase's (d)): for each
   draw and seed pair (the phase's (11, 13), then (s, s)), per model:
   - "loss": each device backpropagates its own loss (the check as it
     stood before it took the CPU's cotangent): card vs CPU, card vs
     float64, CPU vs float64, and for the vocoder the card with torch's
     autograd of the plain |STFT| in place of the backward kernel, vs
     float64 and vs the card;
   - "check": chip_smoke.cotangent_grads (the card, and the float64
     reference, backpropagate the CPU loss's cotangent with every relu and
     leaky ReLU on the CPU's branches): card vs CPU (the check), card vs
     float64, CPU vs float64, and two controls against the CPU: the card
     with TF32 convolutions and matmuls, and (generator) the card's
     BatchNorms with their batch moments detached in the backward.
   Every delta is chip_smoke._leaf_delta with the check's floor
   (TRAIN_GRAD_FLOOR; "loss": the old check's 1e-4), and "check" keeps
   per leaf max|CPU|, max|card - CPU|, max|TF32 card - CPU| and
   max|CPU - float64|.  The float64 reference is the same model and
   inputs in float64 on the CPU.
Prints the card's name and power limit first, then a JSON line per row
and the spread per family.
"""
import contextlib
import json
import os
import sys
import tempfile
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch import nn  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ssr_eval_tpu_torch import device as port_device  # noqa: E402
from ssr_eval_tpu_torch.dsp import spectral  # noqa: E402
from ssr_eval_tpu_torch.dsp.stft_kernel import stft_magnitude_plain  # noqa: E402
from ssr_eval_tpu_torch.models import nvsr  # noqa: E402
from ssr_eval_tpu_torch.models.testees import NVSRTestee  # noqa: E402
from ssr_eval_tpu_torch.models.unet import FlaxBatchNorm  # noqa: E402

CONTROL_BITS = (4, 6)
OLD_FLOOR = 1e-4  # the gradient check's floor before it took the CPU's cotangent and branches
KINDS = ("generator", "vocoder")


@torch.no_grad()
def untruncated(model, seed):
    """`init_weights`, then every conv / transposed conv / Linear weight ~
    N(0, 1/fan_in), in module order from one CPU generator."""
    nvsr.init_weights(model, seed)
    g = torch.Generator().manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, nvsr._WEIGHTED) and m.weight.device.type != "meta":
            w = m.weight
            out_axis = 1 if isinstance(m, (nn.ConvTranspose1d, nn.ConvTranspose2d)) else 0
            w.copy_(torch.randn(w.shape, generator=g) / (w.numel() // w.shape[out_axis]) ** 0.5)
        elif isinstance(m, nn.GRU):
            raise ValueError("the UNet and the TFGAN vocoder hold no GRU")
    return model


DRAWS = {"port": nvsr.init_weights, "untruncated": untruncated}


@torch.no_grad()
def rounded(model, bits):
    """Every parameter's mantissa rounded to `bits` bits, in place."""
    for p in model.parameters():
        m, e = torch.frexp(p)
        p.copy_(torch.ldexp(torch.round(m * 2.0**bits) / 2.0**bits, e))
    return model


# -- bf16 --------------------------------------------------------------


def fp32_run(root, draw, seed):
    fp = NVSRTestee(model_name="unet", seed=seed, device="cuda")
    if draw != "port":
        fp._set_base(DRAWS[draw](fp._base.cpu(), seed))
    res = cs._nvsr_helper(fp, root, cs.NVSR_CUTOFFS, cs.NVSR_BATCH, name="fp32").evaluate(verbose=False)
    return fp, res


def bf16_row(root, draw, seed, bits=None):
    fp, res_fp = fp32_run(root, draw, seed)
    base = fp._base if bits is None else rounded(fp._base, bits)
    d, finite, _, _ = cs.nvsr_bf16_vs_fp32(root, res_fp, seed=seed, base=base)
    log_sispec = [m["log_sispec"] for m in cs._pairs(res_fp).values()]
    del fp, base
    cs._free_card()
    return {"draw": draw, "seed": seed, "control_bits": bits, "delta": d, "over": cs.bf16_over(d, finite),
            "fp32_log_sispec": [min(log_sispec), float(np.median(log_sispec)), max(log_sispec)]}


# -- gradients ---------------------------------------------------------


@contextlib.contextmanager
def float64_path():
    """A float64 model runs in float64 inside: a cast to float32 leaves a
    float64 tensor as it is (the models cast their outputs, and the mel its
    input, back to float32 after a bf16 autocast), and the |STFT| of a
    float64 tensor is the plain version in float64 (the kernel's wrapper
    takes float32 only)."""
    to, kernel = torch.Tensor.to, spectral.stft_magnitude_kernel

    def to64(self, *args, **kw):
        if args == (torch.float32,) and not kw and self.dtype == torch.float64:
            return self
        return to(self, *args, **kw)

    def kernel64(ext, n_fft, hop, max_frames, window):
        if ext.dtype == torch.float64:
            return stft_magnitude_plain(ext, n_fft, hop, max_frames, window.to(ext.dtype))
        return kernel(ext, n_fft, hop, max_frames, window)

    torch.Tensor.to, spectral.stft_magnitude_kernel = to64, kernel64
    try:
        yield
    finally:
        torch.Tensor.to, spectral.stft_magnitude_kernel = to, kernel


@contextlib.contextmanager
def plain_stft_on_card():
    """The |STFT| of a card tensor through torch's autograd of the plain
    version instead of the kernel and its backward."""
    kernel = spectral.stft_magnitude_kernel
    spectral.stft_magnitude_kernel = stft_magnitude_plain
    try:
        yield
    finally:
        spectral.stft_magnitude_kernel = kernel


@contextlib.contextmanager
def tf32_on_card():
    """TF32 convolutions and matmuls on the card (the port pins them off
    in resolve_device)."""
    pin = port_device.pin_precision
    port_device.pin_precision = lambda: None
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        port_device.pin_precision = pin
        pin()


def detached_bn_moments(model):
    """Every FlaxBatchNorm of `model` normalises with its batch moments
    detached: the forward unchanged, the backward without the moments'
    gradient (a BatchNorm backward that forgets them)."""
    def detached(self, x):
        dims, shape = [0, *range(2, x.dim())], [1, -1] + [1] * (x.dim() - 2)
        mean, mean_sq = x.mean(dims).detach(), (x * x).mean(dims).detach()
        mul = torch.rsqrt(torch.clamp(mean_sq - mean * mean, min=0.0) + self.eps) * self.weight
        return (x - mean.reshape(shape)) * mul.reshape(shape) + self.bias.reshape(shape)

    for m in model.modules():
        if isinstance(m, FlaxBatchNorm):
            m.forward = types.MethodType(detached, m)
    return model


def own_loss_grads(case):
    case[2]().backward()
    return cs._grads_of(case[0])


def grad_row(draw, seeds, dev="cuda"):
    init = DRAWS[draw]
    row = {"draw": draw, "seeds": list(seeds)}
    for kind, seed in zip(KINDS, seeds):
        def case(device=dev, dtype=None):
            return cs.gradient_case(kind, device, seed, init, dtype)

        def delta(ref, got, floor=cs.TRAIN_GRAD_FLOOR):
            return cs._leaf_delta(ref, got, floor)

        cpu, card = own_loss_grads(case("cpu")), own_loss_grads(case())
        with float64_path():
            f64 = own_loss_grads(case("cpu", torch.float64))
        loss = {"card_vs_cpu": delta(cpu, card, OLD_FLOOR), "card_vs_f64": delta(f64, card, OLD_FLOOR),
                "cpu_vs_f64": delta(f64, cpu, OLD_FLOOR)}
        if kind == "vocoder":
            with plain_stft_on_card():
                plain = own_loss_grads(case())
            loss["card_plain_stft_vs_f64"] = delta(f64, plain, OLD_FLOOR)
            loss["card_plain_stft_vs_card"] = delta(card, plain, OLD_FLOOR)
        with float64_path():
            c_cpu, c_card, c_f64 = cs.cotangent_grads(case("cpu"), case(), case("cpu", torch.float64))
        with tf32_on_card():
            t_cpu, t_card = cs.cotangent_grads(case("cpu"), case())
        check = {"card_vs_cpu": delta(c_cpu, c_card), "card_vs_f64": delta(c_f64, c_card),
                 "cpu_vs_f64": delta(c_f64, c_cpu), "tf32_card_vs_cpu": delta(t_cpu, t_card)}
        if kind == "generator":
            card_case = case()
            detached_bn_moments(card_case[0])
            check["bn_detached_card_vs_cpu"] = delta(*cs.cotangent_grads(case("cpu"), card_case))

        def diff(ref, got, k):
            return (got[k].cpu().double() - ref[k].double()).abs().max().item()

        # per leaf: max|CPU|, max|card - CPU|, max|TF32 card - CPU|, max|CPU - float64|
        check["leaves"] = {k: [c_cpu[k].abs().max().item(), diff(c_cpu, c_card, k), diff(t_cpu, t_card, k),
                               diff(c_f64, c_cpu, k)] for k in c_cpu}
        row[kind] = {"loss": loss, "check": check}
    return row


def _spread(values, limit=None):
    out = f"min {min(values):.4e}, median {float(np.median(values)):.4e}, max {max(values):.4e}"
    return out if limit is None else f"{out}; {sum(v > limit for v in values)} of {len(values)} past {limit}"


def main():
    if not torch.cuda.is_available():
        sys.exit("init_checks.py needs a CUDA card")
    args = sys.argv[1:]
    grads_only = "--grads" in args
    seeds = [int(s) for s in args if s != "--grads"] or [cs.NVSR_SEED, 0, 1, 2, 3, 4, 5]
    card = cs.card_line()
    print(card, flush=True)
    cs.phase_build()
    grads, rows = [], []

    def show(tag, row):
        print(f"[init_checks] {tag} {json.dumps(row)}", flush=True)

    for draw in DRAWS:
        for i, seed in enumerate(seeds):
            grads.append(grad_row(draw, (11, 13) if i == 0 else (seed, seed)))
            show("gradients", grads[-1])
    for draw in DRAWS:
        for kind in KINDS:
            for form in ("loss", "check"):
                for key in (k for k in grads[0][kind][form] if k != "leaves"):
                    vals = [r[kind][form][key][0] for r in grads if r["draw"] == draw]
                    limit = cs.TRAIN_CARD_VS_CPU[kind] if key.endswith("card_vs_cpu") else None
                    print(f"[init_checks] {draw} {kind} {form} {key}: {_spread(vals, limit)}", flush=True)

    with tempfile.TemporaryDirectory() as work:
        if grads_only:
            seeds = []
        os.chdir(work)  # the helper writes results/ here
        root = os.path.join(work, "sweep_data")
        if seeds:
            cs._write_sweep_data(root)
        for draw in DRAWS:
            for seed in seeds:
                rows.append(bf16_row(root, draw, seed))
                show("bf16 vs fp32", rows[-1])
        for bits in CONTROL_BITS if seeds else ():
            rows.append(bf16_row(root, "port", cs.NVSR_SEED, bits))
            show("bf16 control vs fp32", rows[-1])
        os.chdir(ROOT)
    for draw in DRAWS if rows else ():
        for k in rows[0]["delta"]:
            vals = [r["delta"][k] for r in rows if r["draw"] == draw and r["control_bits"] is None]
            print(f"[init_checks] {draw}: max |bf16 - fp32| {k} over seeds {seeds}: "
                  f"{_spread(vals, cs.NVSR_BF16.get(k))}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
