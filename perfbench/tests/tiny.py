"""Tiny sizes of the benchmark's configurations and mixes, for the CPU."""
from __future__ import annotations

import copy

from perfbench import manifest


def config(name: str) -> dict:
    cfg = copy.deepcopy(manifest.read_json("configs", name))
    cfg["volume"] = [40, 36, 20]
    if cfg["serve"]["roi"] is not None:
        cfg["serve"]["roi"] = [32, 32, 16]
    cfg["pointseg"]["num_points"] = 2048
    cfg["saliency"]["patch_size"] = [16, 32, 32]
    # the limits were read at the cells' sizes; over a tiny window bf16's
    # rounding spreads wider than over millions of voxels, so the tiny
    # serving path runs its saliency net in f32 (the point net is f32 on
    # the CPU anyway)
    cfg["serve"]["saliency_bf16"] = False
    return cfg


def traffic(name: str) -> dict:
    t = copy.deepcopy(manifest.read_json("traffic", name))
    if "pool" in t:
        t["pool"] = [max(50, v // 400) for v in t["pool"]]
    if "check_from" in t:
        t["check_from"], t["check_count"] = 1, 1
    return t
