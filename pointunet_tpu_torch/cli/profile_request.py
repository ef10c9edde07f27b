"""Profile one served BraTS request of the fused path on a CUDA card.

    python -m pointunet_tpu_torch.cli.profile_request [--out chiprun_out]

Builds the serving pipeline (random weights, seed 0) at the BraTS shape
(4x240x240x155, ROI 192x208x155, 365,000 points) on a synthetic
ellipsoid brain made on the card from a seed, and prints:

1. ``segment_device`` wall times of warm requests (host clock, device
   synced before and after);
2. under ``torch.profiler``: the wall per request, the device busy share
   (union of kernel intervals / wall), the peak device memory of one
   request, and the ops that hold the most device time;
3. the attention stage's ops grouped by input shape (which convolutions
   cuDNN runs slowly);
4. the point net's forward in bf16 and in f32 on one cloud: times (CUDA
   events) and how often their argmax agrees (TF32 off for the f32 run).
   Random weights put one large offset on each class's logit, so that
   every point would take one class; the head's bias is first centred on
   this cloud's mean f32 logits, leaving the point-dependent part to pick
   the class (as the CPU parity tests do). This changes the model, so it
   runs last.

``--out`` also writes the full tables and a Chrome trace there.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import time

import torch

from ..pipeline.fused import FusedPointUnet
from .segment import build_pipeline

VOLUME = (240, 240, 155)


def _synthetic_volume(dev, seed=1):
    """(4, X, Y, Z) normal noise inside the bench's ellipsoid brain."""
    g = torch.Generator(device=dev).manual_seed(seed)
    mods = torch.randn((4,) + VOLUME, generator=g, device=dev)
    ax = [torch.arange(n, device=dev, dtype=torch.float32) for n in VOLUME]
    xx, yy, zz = torch.meshgrid(*ax, indexing="ij")
    brain = (((xx - 120) / 75) ** 2 + ((yy - 122) / 88) ** 2
             + ((zz - 76) / 70) ** 2) < 1
    return mods * brain


def _busy_ms(prof) -> float:
    """Length of the union of the device's kernel intervals, in ms."""
    spans = sorted(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == torch.autograd.DeviceType.CUDA
    )
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    return busy / 1e3


def _wall_ms(fn, repeats=1) -> float:
    """Host-clock ms per call, the device synced before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / repeats


def _cuda_ms(fn, repeats) -> float:
    """CUDA-event ms per call over ``repeats`` calls after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats


def main(argv=None) -> None:
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n_point", type=int, default=365_000)
    parser.add_argument("--roi", type=int, nargs=3, default=(192, 208, 155))
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--out", type=str, default=None,
                        help="directory for the full tables and the trace")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_request: no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    p = build_pipeline(args.n_point)
    pipe = FusedPointUnet(
        p.saliency_model, p.pointseg_model, p.scfg, p.pcfg,
        volume_shape=VOLUME, roi_shape=args.roi, device=dev,
    )
    mods = _synthetic_volume(dev)
    gen = torch.Generator(device=dev)

    def request():
        gen.manual_seed(0)
        return pipe.segment_device(mods, gen)

    for _ in range(2):
        request()
    walls = [_wall_ms(request) for _ in range(args.repeats)]
    print("[1] segment_device ms (host clock, warm):",
          [round(w, 3) for w in walls], flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    request()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = _wall_ms(request, 3)
    busy = _busy_ms(prof) / 3
    print(f"[2] profiled: wall {wall:.3f} ms a request, device busy "
          f"{busy:.3f} ms, busy share {busy / wall:.4f}; peak device "
          f"memory {peak:.3f} GB", flush=True)
    ka = prof.key_averages()
    print(ka.table(sort_by="cuda_time_total", row_limit=25,
                   max_name_column_width=60), flush=True)

    with torch.inference_mode():
        pipe._attention_mask(mods)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=True) as shapes:
            mask = pipe._attention_mask(mods)
            torch.cuda.synchronize()
        print("[3] attention stage by input shape:", flush=True)
        print(shapes.key_averages(group_by_input_shape=True).table(
            sort_by="cuda_time_total", row_limit=14, max_name_column_width=40,
            max_shapes_column_width=140,
        ), flush=True)

        gen.manual_seed(0)
        cloud = pipe._sample(mods, mask, gen)
        pyr = pipe._pyramid_fn(cloud.xyz)
        feats = torch.cat([cloud.xyz, cloud.features], -1)
        feats = feats[pyr.order[0].long()][None]
        pm = pipe.pointseg_model
        config = pm.config
        tf32 = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        logits = {}
        try:
            pm.config = dataclasses.replace(config, use_bfloat16=False)
            with torch.no_grad():
                pm.head.bias -= pm(feats, pyr)[0].float().mean(0)
            for bf16 in (True, False):
                pm.config = dataclasses.replace(config, use_bfloat16=bf16)
                logits[bf16] = pm(feats, pyr)[0].float()
                ms = _cuda_ms(lambda: pm(feats, pyr), 5)
                classes = torch.bincount(logits[bf16].argmax(-1), minlength=4)
                print(f"[4] point net {'bf16' if bf16 else 'f32'}: forward "
                      f"{ms:.3f} ms, points per class {classes.tolist()}",
                      flush=True)
        finally:
            pm.config = config
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
        agree = (logits[True].argmax(-1) == logits[False].argmax(-1))
        diff = (logits[True] - logits[False]).abs().max()
        print(f"[4] bf16 vs f32 argmax agreement {agree.float().mean():.8f}, "
              f"max |logit difference| {float(diff):.4f}", flush=True)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "request_ops.txt"), "w") as f:
            f.write(ka.table(sort_by="cuda_time_total", row_limit=-1))
        prof.export_chrome_trace(os.path.join(args.out, "request_trace.json"))


if __name__ == "__main__":
    main()
