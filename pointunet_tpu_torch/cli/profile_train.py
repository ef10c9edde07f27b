"""Profile the port's point-seg train step on a CUDA card.

    python -m pointunet_tpu_torch.cli.profile_train [--out DIR]

Builds the BraTS trainer (``brats_pointseg_config``: 365,000 points, k=16,
ratios (4,4,4,4,2), d_out (16,64,128,256,512), bf16 by the auto policy;
random weights, seed 0) and a synthetic cloud made on the card from a
seed (an all-voxel tumour ball of a 240x240x155 volume plus random
background voxels, labelled by tumour shell), and prints:

1. the step split of warm steps by the tracer's device spans (pyramid,
   forward, backward, optimizer) and the host-clock wall of the step; the
   gather backwards a step (the tracer's counter ``gather_backward``) and
   their device ms where the step timed them (span ``gather.backward``);
2. under ``torch.profiler`` over ``--steps`` steps: the wall and device
   busy share per step, the peak device memory of one step, the ops that
   hold the most device time, and the gather-backward share: device time
   under ``SortedGatherBackward`` (the sorted scatter, kernel 2, with its
   cell and sort preparation) and ``IndexSelectBackward0`` (the
   ``index_add_`` of the small levels and the up-sample), each over the
   step's device busy time.

``--out`` also writes the full op table and a Chrome trace there.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import time

import torch

from ..core import trace
from ..core.config import brats_pointseg_config
from ..ops import scatter_sorted
from ..train.pointseg import PointSegTrainer, TrainState
from .profile_request import _busy_ms

VOLUME = (240, 240, 155)
SPLIT = {"pyramid": "train.pyramid", "forward": "train.forward_loss",
         "backward": "train.backward", "optimizer": "train.update"}


def synthetic_cloud(dev, n_point: int, seed: int = 0):
    """(1, N, 3) xyz (voxel coords / dims), (1, N, 7) features
    cat(xyz, 4 noisy channels), (1, N) labels: every voxel of a tumour
    ball (radius 30, z squeezed 1.5x; labels 1-3 by shell) plus random
    voxels of the rest of the volume (label 0), shuffled."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ax = [torch.arange(n, device=dev, dtype=torch.float32) for n in VOLUME]
    xx, yy, zz = torch.meshgrid(*ax, indexing="ij")
    d = torch.sqrt((xx - 120) ** 2 + (yy - 110) ** 2 + ((zz - 70) * 1.5) ** 2)
    tumour = torch.nonzero((d < 30).reshape(-1)).squeeze(1)[:n_point]
    rest = torch.nonzero((d >= 30).reshape(-1)).squeeze(1)
    rest = rest[torch.randperm(rest.numel(), generator=g, device=dev)]
    flat = torch.cat([tumour, rest[: n_point - tumour.numel()]])
    flat = flat[torch.randperm(flat.numel(), generator=g, device=dev)]
    dims = torch.tensor(VOLUME, device=dev)
    coords = torch.stack([
        flat // (dims[1] * dims[2]), (flat // dims[2]) % dims[1], flat % dims[2]
    ], 1)
    xyz = coords.float() / dims.float()
    dist = d.reshape(-1)[flat]
    labels = torch.bucketize(-dist, torch.tensor([-30.0, -20.0, -10.0],
                                                 device=dev))
    mods = torch.randn((flat.numel(), 4), generator=g, device=dev)
    mods += labels[:, None].float()
    return xyz[None], torch.cat([xyz, mods], 1)[None], labels[None]


def timed_step(trainer: PointSegTrainer, state: TrainState, xyz, feats,
               labels):
    """One ``train_step`` on device tensors, split into the pyramid, the
    forward and loss, the backward and the optimizer by the device spans
    of its tracer record: (metrics, {stage: ms}). The metrics hold the
    global batch's loss (summed over a mesh), the accuracy and
    ``peak_gb``: this process's (under a mesh, this rank's) peak device
    memory since the caller last reset it
    (``torch.cuda.reset_peak_memory_stats``)."""
    _, m = trainer.train_step(state, xyz, feats, labels)
    torch.cuda.synchronize()
    rec = trace.records()[-1]
    split = {name: trace.span_ms(rec, span, "device")
             for name, span in SPLIT.items()}
    return dict(m, peak_gb=torch.cuda.max_memory_allocated() / 1e9), split


def _device_ms(entry) -> float:
    """Device time (ms) under a profiler key-average entry."""
    total = getattr(entry, "device_time_total", None)
    if total is None:
        total = entry.cuda_time_total
    return total / 1e3


def main(argv=None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--n_point", type=int, default=365_000)
    parser.add_argument("--warmup", type=int, default=2)
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--out", type=str, default=None,
                        help="directory for the full table and the trace")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device")
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    trainer = PointSegTrainer(brats_pointseg_config(num_points=args.n_point),
                              device="cuda")
    state = trainer.init_state()
    xyz, feats, labels = synthetic_cloud(dev, args.n_point)
    print(f"cloud {tuple(xyz.shape)}, points per class "
          f"{torch.bincount(labels[0], minlength=4).tolist()}", flush=True)

    for _ in range(args.warmup):
        trainer.train_step(state, xyz, feats, labels)
    splits = []
    for _ in range(args.steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, split = timed_step(trainer, state, xyz, feats, labels)
        split["wall"] = (time.perf_counter() - t0) * 1e3
        splits.append(split)
    mean = {k: sum(s[k] for s in splits) / len(splits) for k in splits[0]}
    print("[1] step split (ms, the tracer's device spans; wall on the host "
          f"clock), mean of {len(splits)}: "
          + ", ".join(f"{k} {v:.3f}" for k, v in mean.items()), flush=True)
    recs = trace.records()[-args.steps:]
    gathers = {"calls": [r["counters"].get("gather_backward", 0) for r in recs],
               "device_ms": [ms for ms in (trace.span_ms(r, "gather.backward", "device")
                                           for r in recs) if ms is not None]}
    print(f"[1] gather backwards a step (the tracer's counter): "
          f"{gathers['calls']}; their device ms in the steps that timed them "
          f"(one of {scatter_sorted.TIMED_EVERY}): {gathers['device_ms']}",
          flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, xyz, feats, labels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            trainer.train_step(state, xyz, feats, labels)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / args.steps
    busy = _busy_ms(prof) / args.steps
    ka = prof.key_averages()
    by_key = {e.key: _device_ms(e) / args.steps for e in ka}
    sorted_bwd = by_key.get("SortedGatherBackward", 0.0)
    select_bwd = by_key.get("IndexSelectBackward0", 0.0)
    kernel2 = sum(v for k, v in by_key.items() if "scatter_sorted_kernel" in k)
    print(f"[2] profiled: wall {wall:.3f} ms a step, device busy {busy:.3f} "
          f"ms, busy share {busy / wall:.4f}; peak device memory {peak:.3f} GB",
          flush=True)
    print(f"[2] gather backward a step: SortedGatherBackward {sorted_bwd:.3f} "
          f"ms (kernel 2 itself {kernel2:.3f} ms), IndexSelectBackward0 "
          f"{select_bwd:.3f} ms; share of device busy time "
          f"{(sorted_bwd + select_bwd) / busy:.4f} (kernel 2 alone "
          f"{kernel2 / busy:.4f})", flush=True)
    print(ka.table(sort_by="cuda_time_total", row_limit=25,
                   max_name_column_width=60), flush=True)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "train_ops.txt"), "w") as f:
            f.write(ka.table(sort_by="cuda_time_total", row_limit=-1))
        prof.export_chrome_trace(os.path.join(args.out, "train_trace.json"))
    return {"split_ms": mean, "gather_backward": gathers, "wall_ms": wall, "busy_ms": busy,
            "peak_gb": peak, "sorted_gather_bwd_ms": sorted_bwd,
            "index_select_bwd_ms": select_bwd, "kernel2_ms": kernel2}


if __name__ == "__main__":
    main()
