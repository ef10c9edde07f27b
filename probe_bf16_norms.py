"""Forms of the bf16 instance norm and the eval-mode batch norm on one CUDA
card: which ones this torch accepts, how far each lies from the exact
value rounded once, and what each costs at the Serve contract's shapes.

    python3 probe_bf16_norms.py [--train]

flax's norms (``flax.linen.normalization._normalize``) compute ``(x -
mean) * (rsqrt(var + eps) * scale) + bias`` in f32 with f32 scale and
bias and round to bf16 once. The instance-norm forms: ``F.group_norm``
with the affine cast to bf16 (the port before the repair), with f32
affine on the bf16 input (mixed types), ``F.instance_norm`` with f32
affine (``batch_norm`` on the (1, B*C, ...) view), f32 statistics from
two reductions of the bf16 input (a sum and ``vector_norm``) applied by
``F.batch_norm`` in eval mode or by ``torch.addcmul`` rounded after, and
``F.group_norm`` of an f32 copy. Each runs on the
inputs of every instance norm of one forward of the Serve saliency net
(bf16, gate stride 2, at the BraTS ROI (1, 4, 160, 208, 192)), captured
by forward hooks, with the affine drawn away from 1 and 0; each prints
its largest distance from the f64 value in bf16 ulps (values below
2^-16 of the largest counted at that floor) and its summed ms (CUDA
events, mean of 10), then the forward's ms with the module's own form.
The batch-norm forms (eval mode, channels last, as the point net runs
them): bf16 arithmetic on bf16-cast statistics, and ``torch.addcmul`` of
the f32 multiplier and shift rounded once, at (1, 365000, 16, C) and (1,
365000, C). Prints the card, then one JSON line.

``--train`` instead times the instance-norm forms that have a backward
on the inputs of every instance norm of one forward of the bf16
training net (the saliency train step's micro-batch, (1, 4, 64, 160,
160)): one forward and its backward of a fixed cotangent
(``torch.autograd.grad``), summed over the norms, the most memory one
norm's forward and backward allocate above its input, and the input
gradient's relative distance from the f64 one. The forms: PyTorch's
``group_norm`` with the affine cast to bf16 (the port before the
repair), autograd through the f32-statistics ``addcmul`` form, and the
module's own (``GroupNorm``: a backward of its own); then, on f32
copies of the same inputs, ``group_norm`` (the module's f32 form)
against the module's bf16 function run in f32.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from pointunet_tpu_torch.core.config import brats_saliency_config
from pointunet_tpu_torch.models.norms import GroupNorm, _InstanceNormOnce
from pointunet_tpu_torch.models.saliency_unet import init_saliency_unet

ROI_INPUT = (1, 4, 160, 208, 192)
TRAIN_INPUT = (1, 4, 64, 160, 160)


def _ms(fn, repeats: int = 10) -> float:
    fn()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    for _ in range(repeats):
        fn()
    ev[1].record()
    torch.cuda.synchronize()
    return ev[0].elapsed_time(ev[1]) / repeats


def _ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    a = want.abs()
    a = a.clamp(min=2.0 ** -16 * float(a.max()))
    u = torch.exp2(torch.floor(torch.log2(a)) - 7)
    return float(((got.double() - want).abs() / u).max())


def _instance_exact(x, w, b, eps):
    x64 = x.double()
    dims = tuple(range(2, x.ndim))
    mu = x64.mean(dims, keepdim=True)
    var = (x64 * x64).mean(dims, keepdim=True) - mu * mu
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return ((x64 - mu) * (torch.rsqrt(var + eps) * w.double().view(shape))
            + b.double().view(shape))


def _f32_stats(x):
    """Per-channel mean and E[x^2] - mean^2 in f32, each reduction reading
    the bf16 input once."""
    dims = tuple(range(2, x.ndim))
    n = x[0, 0].numel()
    mean = x.sum(dims, dtype=torch.float32) / n
    sq = torch.linalg.vector_norm(x, 2, dims, dtype=torch.float32).square()
    return mean, (sq / n - mean * mean).clamp_min(0.0)


def _stats_batch_norm(x, w, b, e):
    mean, var = _f32_stats(x)
    bsz, c = x.shape[:2]
    return F.batch_norm(x.reshape(1, bsz * c, -1), mean.reshape(-1),
                        var.reshape(-1), w.repeat(bsz), b.repeat(bsz),
                        False, 0.0, e).view_as(x)


def _stats_addcmul(x, w, b, e):
    mean, var = _f32_stats(x)
    scale = torch.rsqrt(var + e) * w
    shape = x.shape[:2] + (1,) * (x.ndim - 2)
    return torch.addcmul((b - mean * scale).view(shape), x,
                         scale.view(shape)).to(x.dtype)


INSTANCE_FORMS = {
    "group_norm_bf16_affine": lambda x, w, b, e: F.group_norm(
        x, x.shape[1], w.to(x.dtype), b.to(x.dtype), e),
    "f32_stats_batch_norm_eval": _stats_batch_norm,
    "f32_stats_addcmul": _stats_addcmul,
    "group_norm_of_f32_copy": lambda x, w, b, e: F.group_norm(
        x.float(), x.shape[1], w, b, e).to(x.dtype),
    "group_norm_f32_affine": lambda x, w, b, e: F.group_norm(
        x, x.shape[1], w, b, e),
    "instance_norm_f32_affine": lambda x, w, b, e: F.instance_norm(
        x, weight=w, bias=b, eps=e),
}


def _bn_forms(x, rm, rv, w, b, eps):
    mul32 = torch.rsqrt(rv + eps) * w
    dt = x.dtype
    return {
        "bf16_arithmetic": lambda: (x - rm.to(dt)) * mul32.to(dt) + b.to(dt),
        "addcmul_f32_once": lambda: torch.addcmul(
            b - rm * mul32, x, mul32).to(dt),
    }


TRAIN_FORMS = {
    "group_norm_bf16_affine": INSTANCE_FORMS["group_norm_bf16_affine"],
    "autograd_f32_stats_addcmul": _stats_addcmul,
    "module_own_backward": lambda x, w, b, e: _InstanceNormOnce.apply(
        x, w, b, e),
}
F32_TRAIN_FORMS = {
    "group_norm_f32": lambda x, w, b, e: F.group_norm(x, x.shape[1], w, b,
                                                      e),
    "module_bf16_function_in_f32": lambda x, w, b, e:
        _InstanceNormOnce.apply(x, w, b, e),
}


def _capture(gen, dev, cfg_kw, shape):
    """(model, [(norm, its input)]) of one forward of a saliency net of
    ``cfg_kw`` on a seeded input of ``shape``, the norms' affine drawn
    away from 1 and 0."""
    model = init_saliency_unet(brats_saliency_config(**cfg_kw),
                               gen).to(dev).eval()
    norms = [m for m in model.modules() if isinstance(m, GroupNorm)]
    with torch.no_grad():
        for m in norms:
            m.weight.copy_(torch.rand(m.weight.shape, generator=gen) + 0.5)
            m.bias.copy_(0.3 * torch.randn(m.bias.shape, generator=gen))
    captured = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: captured.append((mod, args[0].clone())))
        for m in norms]
    x = torch.randn(shape, generator=gen).to(dev)
    with torch.inference_mode():
        model(x)
    for h in hooks:
        h.remove()
    return model, x, captured


def _train_rows(captured, forms, dtype, gen) -> dict:
    """Each form's summed forward + backward ms, its largest allocation
    above one norm's input, and its input gradient's relative L2
    distance from the f64 one, over ``captured`` cast to ``dtype``."""
    cases = []
    for mod, inp in captured:
        if inp[0, 0].numel() == 1:
            continue
        x = inp.to(dtype, copy=True)
        g = torch.randn(x.shape, generator=gen).to(x.device, dtype)
        w = mod.weight.detach().clone().requires_grad_()
        b = mod.bias.detach().clone().requires_grad_()
        x64 = x.double().requires_grad_()
        (want,) = torch.autograd.grad(F.group_norm(
            x64, x.shape[1], w.double(), b.double(), mod.eps), x64,
            g.double())
        cases.append((x.requires_grad_(), w, b, mod.eps, g, want))
    rows = {}
    for name, form in forms.items():
        row = {"ms": 0.0, "peak_gb": 0.0, "num": 0.0, "den": 0.0}
        try:
            for x, w, b, eps, g, want in cases:
                def fb():
                    return torch.autograd.grad(form(x, w, b, eps),
                                               (x, w, b), g)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                dx = fb()[0]
                row["peak_gb"] = max(row["peak_gb"], (
                    torch.cuda.max_memory_allocated() - base) / 1e9)
                assert dx.dtype == x.dtype
                row["num"] += float(((dx.double() - want) ** 2).sum())
                row["den"] += float((want ** 2).sum())
                del dx
                row["ms"] += _ms(fb)
            row = {"ok": True, "ms": row["ms"], "peak_gb": row["peak_gb"],
                   "dx_rel_l2": (row["num"] / row["den"]) ** 0.5}
        except (RuntimeError, AssertionError) as e:
            row = {"ok": False, "error": str(e)[:300]}
        rows[name] = row
        print(f"[train {dtype}] {name}: {row}", flush=True)
    return rows


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--train", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("probe_bf16_norms: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.benchmark = False
    gen = torch.Generator().manual_seed(0)
    if args.train:
        _, _, captured = _capture(gen, dev, {"use_bfloat16": True},
                                  TRAIN_INPUT)
        out = {"card": card, "instance_calls": len(captured),
               "bf16": _train_rows(captured, TRAIN_FORMS, torch.bfloat16,
                                   gen),
               "f32": _train_rows(captured, F32_TRAIN_FORMS, torch.float32,
                                  gen)}
        print(json.dumps(out), flush=True)
        return out
    model, x, captured = _capture(gen, dev, {"use_bfloat16": True,
                                             "sa_gate_stride": 2}, ROI_INPUT)
    out = {"card": card, "instance_calls": len(captured),
           "instance": {}, "batch": {}}
    for name, form in INSTANCE_FORMS.items():
        row = {"ok": True, "ms": 0.0, "ulps": 0.0}
        try:
            with torch.inference_mode():
                for mod, inp in captured:
                    if inp[0, 0].numel() == 1:
                        continue
                    args = (inp, mod.weight, mod.bias, mod.eps)
                    got = form(*args)
                    row["ulps"] = max(row["ulps"], _ulps(
                        got, _instance_exact(*args)))
                    row["ms"] += _ms(lambda: form(*args))
                    assert got.dtype == inp.dtype
        except (RuntimeError, AssertionError) as e:
            row = {"ok": False, "error": str(e)[:300]}
        out["instance"][name] = row
        print(f"[instance] {name}: {row}", flush=True)
    with torch.inference_mode():
        out["forward_ms"] = _ms(lambda: model(x), repeats=5)
    print(f"[forward] {out['forward_ms']:.3f} ms", flush=True)
    for shape in ((1, 365000, 16, 16), (1, 365000, 16, 32),
                  (1, 365000, 32), (1, 91250, 16, 64)):
        c = shape[-1]
        x = torch.randn(shape, generator=gen).to(dev).bfloat16()
        stats = [torch.randn(c, generator=gen).to(dev),
                 (torch.rand(c, generator=gen) + 0.5).to(dev),
                 (torch.rand(c, generator=gen) + 0.5).to(dev),
                 (0.3 * torch.randn(c, generator=gen)).to(dev)]
        rm, rv, w, b = stats
        want = ((x.double() - rm.double()) * (torch.rsqrt(rv.double() + 1e-6)
                 * w.double()) + b.double())
        rows = {}
        for name, form in _bn_forms(x, rm, rv, w, b, 1e-6).items():
            with torch.inference_mode():
                rows[name] = {"ms": _ms(form), "ulps": _ulps(form(), want)}
        out["batch"][str(shape)] = rows
        print(f"[batch] {shape}: {rows}", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
    sys.exit(0)
