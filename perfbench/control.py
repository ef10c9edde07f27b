"""Readings that set a cell's limits: the program's numbers on many seeds,
and the control's (the plain reference in the next lower precision, put
in the program's place) on the same requests.

    python3 perfbench/control.py --workload brats.serve --seeds 12 \
        --first 1000 [--out readings.jsonl]

For each seed it builds the cell as a run does, serves the requests a run
would check (``check_count`` of them, drawn from the seed), and prints one
JSON line: the judge's numbers of the program (``program``) and of the
control (``control``). The benchmark's own runs never run the control.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def serve_readings(cfg, traffic, seed, dev):
    from perfbench import spans, weights
    from perfbench.generators import serve_volumes as sv
    from perfbench.reference import judge_serve

    pipe, w = sv.build(cfg, seed, dev)
    volumes = sv.pool(cfg, traffic, seed, dev)
    sp = spans.Spans(timed=False)
    for method, name in sv.STAGES:
        sp.wrap(pipe, method, name)
    rng = random.Random(weights.sub_seed(seed, 4))
    items = []
    for i in sorted(rng.sample(range(traffic["check_from"]),
                               traffic["check_count"])):
        sp.capture = {}
        hooks = sv._hook_outputs(pipe, sp.capture)
        labels = pipe.segment_volume(volumes[i % len(volumes)],
                                     seed=weights.sub_seed(seed, 5, i),
                                     brats_labels=cfg["serve"]["brats_labels"])
        for h in hooks:
            h.remove()
        items.append((volumes[i % len(volumes)], dict(sp.capture, labels=labels)))
    program = judge_serve.judge(cfg, w, items, dev)
    control = judge_serve.judge(cfg, w, items, dev, one=judge_serve.control_one)
    return {"program": program, "control": control}


def train_point_readings(cfg, traffic, seed, dev):
    from perfbench import weights
    from perfbench.generators import train_points as tp
    from perfbench.reference import judge_train, randlanet
    from perfbench.reference.precision import FP8, strict_f32

    trainer, state, w0 = tp.build(cfg, seed, dev)
    clouds = tp.pool(cfg, traffic, seed, dev)
    n = traffic["checked_steps"]
    port = tp.first_steps(trainer, state, clouds, w0, n,
                          lambda i: trainer.train_step(state, *clouds[i])[1])
    del trainer, state
    with strict_f32():
        ref = randlanet.train_steps(cfg, w0, clouds[:n], weights.sub_seed(seed, 12))
        low = randlanet.train_steps(cfg, w0, clouds[:n], weights.sub_seed(seed, 12),
                                    FP8())
        frozen = randlanet.train_steps(cfg, w0, clouds[:n],
                                       weights.sub_seed(seed, 12), lr_scale=0.0)
        frozen.pop("logits0")
    return {"program": judge_train.judge(port, ref),
            "control": judge_train.judge(low, ref),
            "unchanged": judge_train.judge(judge_train.unchanged(frozen), ref),
            "losses": {"program": port["losses"], "reference": ref["losses"]}}


def train_saliency_readings(cfg, traffic, seed, dev):
    from perfbench import device as device_mod
    from perfbench.generators import train_patches as tp
    from perfbench.reference import judge_train, saliency
    from perfbench.reference.precision import strict_f32

    n = traffic["checked_steps"]
    batches = tp.pool(cfg, traffic, seed, dev)
    runs = {}
    for name, bf16 in (("program", False), ("control", True)):
        trainer, state, w0 = tp.build(cfg, seed, dev, bf16=bf16)
        runs[name] = tp.first_steps(
            state, w0, n, lambda i: trainer.train_step(state, *batches[i])[1])
        del trainer, state
        device_mod.release(dev)
    half = cfg["saliency"]["batch_size"] // 2
    with strict_f32():
        ref = saliency.train_steps(cfg, w0, batches[:n])
        part = saliency.train_steps(cfg, w0, [tuple(t[:half] for t in b)
                                             for b in batches[:n]])
        frozen = saliency.train_steps(cfg, w0, batches[:n], lr_scale=0.0)
        frozen.pop("logits0")
    return {"program": judge_train.judge(runs["program"], ref),
            "control": judge_train.judge(runs["control"], ref),
            "half_batch": judge_train.judge(part, ref),
            "unchanged": judge_train.judge(judge_train.unchanged(frozen), ref),
            "losses": {"program": runs["program"]["losses"],
                       "reference": ref["losses"]}}


def main(argv=None) -> int:
    import torch
    from perfbench import device as device_mod, manifest

    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first", type=int, default=1000)
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    print(device_mod.card_line(), flush=True)
    m = manifest.load()
    w = manifest.workload(m, args.workload)
    cfg = manifest.read_json("configs", w["config"])
    traffic = manifest.read_json("traffic", w["traffic"])
    readings = {"serve_volumes": serve_readings,
                "train_points": train_point_readings,
                "train_patches": train_saliency_readings}[traffic["generator"]]
    dev = torch.device("cuda", 0)
    out = open(args.out, "a") if args.out else None
    for seed in range(args.first, args.first + args.seeds):
        t0 = time.perf_counter()
        line = dict(readings(cfg, traffic, seed, dev), seed=seed,
                    workload=args.workload,
                    seconds=time.perf_counter() - t0)
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
