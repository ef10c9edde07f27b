"""Time the port's point-net train step on one CUDA card, for one or more
trees of the repo in turn.

    python3 probe_train_step.py [--trees DIR ...] [--steps 10]

Each tree (a directory that holds ``pointunet_tpu_torch``; by default
this checkout) runs in a process of its own with that directory first on
``sys.path``, so two commits compare on one card in one call (``--trees
old new new old``). In each process, for the BraTS config at 365,000
points and the Pancreas config (``pancreas_pointseg_config``) at 180,000:
random weights from seed 0, the cloud of ``profile_train.synthetic_cloud``
(features cut to xyz and the config's channels, labels clipped to its
classes), one warm-up step, then ``--steps`` steps split by the
tracer's device spans (``profile_train.timed_step``) with each step's
wall on the host clock, and one more step under ``torch.profiler`` for the device's busy share.
It prints the card's name and power limit, a line per tree and config,
and, last, a JSON object of them all (ms).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CONFIGS = (("brats", 365_000), ("pancreas", 180_000))


def child(tree: str, steps: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import pointunet_tpu_torch
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pointunet_tpu_torch.cli.profile_request import _busy_ms
    from pointunet_tpu_torch.cli.profile_train import (
        synthetic_cloud,
        timed_step,
    )
    from pointunet_tpu_torch.core import config
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    if not pointunet_tpu_torch.__file__.startswith(os.path.abspath(tree)):
        raise SystemExit(f"imported {pointunet_tpu_torch.__file__}, "
                         f"not the tree {tree}")
    dev = torch.device("cuda", 0)
    out = {}
    for name, n in CONFIGS:
        cfg = getattr(config, f"{name}_pointseg_config")(num_points=n)
        torch.manual_seed(0)
        trainer = PointSegTrainer(cfg, device="cuda")
        state = trainer.init_state()
        xyz, feats, labels = synthetic_cloud(dev, n)
        feats = feats[..., :3 + cfg.num_features].contiguous()
        labels = labels.clamp(max=cfg.num_classes - 1)
        timed_step(trainer, state, xyz, feats, labels)
        splits = []
        for _ in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, split = timed_step(trainer, state, xyz, feats, labels)
            split["step"] = sum(split.values())
            split["wall"] = (time.perf_counter() - t0) * 1e3
            splits.append(split)
        mean = {k: sum(s[k] for s in splits) / steps for k in splits[0]}
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_step(state, xyz, feats, labels)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        mean["profiled_wall"] = wall
        mean["busy"] = _busy_ms(prof)
        mean["busy_share"] = mean["busy"] / wall
        mean["steps_ms"] = [s["step"] for s in splits]
        out[name] = mean
        del trainer, state, prof
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--trees", nargs="+",
                        default=[os.path.dirname(os.path.abspath(__file__))])
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--child", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print("RESULT " + json.dumps(child(args.child, args.steps)), flush=True)
        return 0
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip(), flush=True)
    runs = []
    for i, tree in enumerate(args.trees):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--child", tree,
             "--steps", str(args.steps)],
            capture_output=True, text=True,
        )
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            raise SystemExit(f"run {i} ({tree}) failed ({proc.returncode})")
        res = json.loads(lines[-1][len("RESULT "):])
        for name, m in res.items():
            print(f"run {i} {tree} {name}: "
                  + ", ".join(f"{k} {v:.3f}" for k, v in m.items()
                              if not isinstance(v, list))
                  + f"; steps {', '.join(f'{v:.3f}' for v in m['steps_ms'])}",
                  flush=True)
        runs.append({"tree": tree, **res})
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
