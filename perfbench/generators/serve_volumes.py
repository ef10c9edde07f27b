"""Volumes served one after another through ``FusedPointUnet.segment_volume``,
the path ``serve`` drains its inbox with: a closed loop of one client.

Traffic parameters (``traffic/<mix>.json``): ``pool``, the tumour (or
organ) voxel counts of the seeded host volumes, drawn from in turn;
``warmup``, the requests served in set-up; ``check_from`` and
``check_count``: the requests whose outputs are compared with the plain
reference, drawn from the seed among the first ``check_from``; ``trace``:
the requests served under the profiler after the window.

Set-up builds the two nets of the configuration's serving path, fills
them from the seed on the device, makes the pool on the device and hands
it to the host (as ``serve`` reads volumes from disk into host memory),
and serves the warm-up requests. The window serves volumes until
``seconds`` have passed; every request is timed on the host clock from
the call to its labels on the host.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time

import torch

from .. import device as device_mod
from .. import phantoms, spans as spans_mod, stats, weights
from ..reference import judge_serve

STAGES = (("_attention_mask", "attention"), ("_sample", "sampling"),
          ("_pyramid_fn", "pyramid"), ("_pointseg_scatter", "pointseg"))


def build(cfg: dict, seed: int, dev):
    """The serving pipeline with seeded weights, and the weights by net."""
    from pointunet_tpu_torch.core.config import PointSegConfig, SaliencyConfig
    from pointunet_tpu_torch.models.randlanet import RandLANet
    from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet
    from pointunet_tpu_torch.pipeline.fused import FusedPointUnet

    serve = cfg["serve"]
    scfg = SaliencyConfig(**_tuples(cfg["saliency"]))
    scfg = dataclasses.replace(scfg, use_bfloat16=serve["saliency_bf16"],
                               sa_gate_stride=serve["sa_gate_stride"])
    pcfg = PointSegConfig(**_tuples(cfg["pointseg"]))
    sal = SaliencyUNet(scfg).to(dev)
    pnt = RandLANet(pcfg).to(dev)
    w = {"saliency": weights.fill(sal, weights.sub_seed(seed, 1)),
         "pointseg": weights.fill(pnt, weights.sub_seed(seed, 2))}
    pipe = FusedPointUnet(
        sal, pnt, scfg, pcfg, threshold=serve["threshold"],
        volume_shape=tuple(cfg["volume"]),
        roi_shape=None if serve["roi"] is None else tuple(serve["roi"]),
        device=dev)
    return pipe, w


def _tuples(d: dict) -> dict:
    return {k: tuple(tuple(x) if isinstance(x, list) else x for x in v)
            if isinstance(v, list) else v for k, v in d.items()}


def pool(cfg: dict, traffic: dict, seed: int, dev):
    g = torch.Generator(device=dev).manual_seed(weights.sub_seed(seed, 3))
    return [phantoms.volume(cfg, v, g, dev).cpu().numpy()
            for v in traffic["pool"]]


def run(cell) -> dict:
    cfg, traffic, seed, dev = cell.cfg, cell.traffic, cell.seed, cell.device
    pipe, w = build(cfg, seed, dev)
    phases = {"built": time.perf_counter() - cell.t0}
    volumes = pool(cfg, traffic, seed, dev)
    phases["pool"] = time.perf_counter() - cell.t0
    sp = spans_mod.Spans(timed=cell.trace)
    for method, name in STAGES:
        sp.wrap(pipe, method, name)
    brats = cfg["serve"]["brats_labels"]
    rng = random.Random(weights.sub_seed(seed, 4))
    checked = set(rng.sample(range(traffic["check_from"]), traffic["check_count"]))

    def request(i: int):
        return pipe.segment_volume(volumes[i % len(volumes)],
                                   seed=weights.sub_seed(seed, 5, i),
                                   brats_labels=brats)

    for i in range(traffic["warmup"]):
        request(i)
    device_mod.sync(dev)
    setup_s = time.perf_counter() - cell.t0

    captured, walls, failed, errors = {}, [], 0, []
    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < cell.seconds:
        hooks = []
        if i in checked:
            sp.capture = {}
            hooks = _hook_outputs(pipe, sp.capture)
        sp.begin()
        t0 = time.perf_counter()
        try:
            labels = request(i)
            walls.append(time.perf_counter() - t0)
        except Exception as exc:       # a request that fails is missing
            failed += 1
            walls.append(math.inf)
            errors.append(f"request {i}: {exc!r}")
            labels = None
        for h in hooks:
            h.remove()
        if sp.capture is not None and labels is not None:
            captured[i] = dict(sp.capture, labels=labels,
                               volume=i % len(volumes))
        sp.capture = None
        i += 1
    window_s = time.perf_counter() - start
    peak = device_mod.peak(dev)
    done = [x for x in walls if math.isfinite(x)]
    out = {
        "phases": phases, "attempted": len(walls), "failed": failed, "errors": errors,
        "setup_s": setup_s, "peak": peak,
        "e2e": {"volumes_per_s": stats.rate(len(done), window_s),
                "latency_p90_ms": stats.percentile(walls, 90) * 1e3,
                "setup_s": setup_s},
        "record": {"walls": walls, "window_s": window_s,
                   "work": cell.counter.serve(cfg), "cfg": cfg},
    }
    if cell.trace:
        out["record"]["rows"] = sp.rows()
        k = traffic["trace"]
        prof = spans_mod.profile(lambda: request(0), k,
                                 stages={n for _, n in STAGES})
        out["profile"] = prof
        out["record"]["profile"] = prof
    missing = sorted(checked - set(captured))
    if missing:
        out["errors"].append(f"requests {missing} to check never completed")
        out["failed"] += len(missing)
    del pipe
    device_mod.release(dev)
    out["checks"] = judge_serve.judge(
        cfg, w, [(volumes[c["volume"]], c) for _, c in sorted(captured.items())],
        dev)
    return out


def _hook_outputs(pipe, store: dict):
    """Forward hooks that keep the saliency net's logits and the point
    net's logits of one request in ``store``."""
    def keep(key):
        def hook(_module, _inputs, output):
            store[key] = output
        return hook
    return [pipe.saliency_model.register_forward_hook(keep("saliency_logits")),
            pipe.pointseg_model.register_forward_hook(keep("point_logits"))]
