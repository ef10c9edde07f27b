"""Operations and bytes of Point-Unet's nets, counted from a configuration's
published widths at a cell's shapes.

An operation is a multiply or an add (a multiply-add is 2). Convolutions
and dense layers are counted, with the attention pools' weighted sums;
norms, activations and softmaxes are not (each is a few operations an
element, under 1 % of the convs'). Bytes are the least a stage has to
move: its inputs read once, its outputs written once, its weights read
once. A bound from these is one no implementation can beat, so a share
of it cannot pass 100 %.
"""
from __future__ import annotations

import math
from typing import Sequence

F32, BF16, I32, BOOL = 4, 2, 4, 1


def _vox(dhw: Sequence[int], scale: int) -> int:
    """Voxels at ``scale`` stride-2 SAME halvings of ``dhw``."""
    out = 1
    for n in dhw:
        for _ in range(scale):
            n = -(-n // 2)
        out *= n
    return out


def saliency_forward(s: dict, dhw: Sequence[int], gate_stride: int) -> dict:
    """One forward of the attention U-Net on a (D, H, W) input: operations
    and parameter count."""
    ops = 0
    params = 0

    def conv(cin, cout, taps, scale):
        nonlocal ops, params
        ops += 2 * cin * cout * taps * _vox(dhw, scale)
        params += cin * cout * taps

    base, depth = s["base_filter"], s["depth"]
    conv(s["in_channels"], base, 27, 0)
    ch, chans = base, []
    for d in range(depth):
        f = base * (2 ** d if s["filter_grow"] else 1)
        if s["residual"] and ch != f:
            conv(ch, f, 1, d)
            ch = f
        conv(ch, f, 27, d)
        conv(f, f, 27, d)
        chans.append(f)
        if d != depth - 1:
            conv(f, 2 * f, 27, d + 1)
            ch = 2 * f
    conv(chans[0], 64, 27, 0)
    conv(chans[1], 64, 27, 1)
    for i, c in enumerate(chans[2:5]):
        conv(c, 32, 1, 2 + i)
        for _ in range(3):
            conv(c, 32, 27, 2 + i)
    conv(128, 128, 27, 2)
    conv(128, 128, 27, 2)
    if s["ca_attention"]:
        ops += 2 * 2 * 384 * 96
        params += 2 * 384 * 96
    conv(384, 64, 1, 2)
    conv(64, 64, 27, 0)
    if s["sa_attention"]:
        g = int(math.log2(gate_stride))
        for _ in range(3):
            conv(64, 32, 81, g)
            conv(32, 1, 9, g)
    conv(64, 64, 27, 0)
    conv(128, 64, 27, 0)
    conv(128, s["num_class"], 27, 0)
    return {"ops": ops, "params": params}


def level_sizes(p: dict, n: int):
    sizes = [n]
    for r in p["sub_sampling_ratio"]:
        sizes.append(sizes[-1] // r)
    return sizes


def pointnet_forward(p: dict, n: int) -> int:
    """Operations of one RandLA-Net forward over an ``n``-point cloud."""
    sizes = level_sizes(p, n)
    k = p["k_n"]

    def dense(i, o, rows):
        return 2 * i * o * rows

    ops = dense(3 + p["num_features"], 8, n)
    d_in, skip = 8, []
    for i in range(p["num_layers"]):
        d = p["d_out"][i]
        h = d // 2
        rows, pairs = sizes[i], sizes[i] * k
        ops += dense(d_in, h, rows)
        ops += dense(10, h, pairs)
        ops += 2 * (dense(2 * h, 2 * h, pairs) + 2 * 2 * h * pairs)
        ops += dense(2 * h, h, rows) + dense(h, h, pairs) + dense(2 * h, d, rows)
        ops += dense(d, 2 * d, rows) + dense(d_in, 2 * d, rows)
        d_in = 2 * d
        if i == 0:
            skip.append(d_in)
        skip.append(d_in)
    ops += dense(d_in, d_in, sizes[p["num_layers"]])
    for j in range(p["num_layers"]):
        c = skip[-j - 2]
        ops += dense(c + d_in, c, sizes[p["num_layers"] - 1 - j])
        d_in = c
    ops += dense(d_in, 64, n) + dense(64, 32, n) + dense(32, p["num_classes"], n)
    return ops


def pyramid_bytes(p: dict, n: int) -> int:
    """The least bytes of building the pyramid: the cloud read, and per
    level its sorted points, neighbours, kept points' neighbours and
    nearest kept point written, with the level-0 order."""
    sizes = level_sizes(p, n)
    k = p["k_n"]
    out = n * 3 * F32 + n * I32
    for i in range(p["num_layers"]):
        out += sizes[i] * 3 * F32 + sizes[i] * k * I32
        out += sizes[i + 1] * k * I32 + sizes[i] * I32
    return out + sizes[-1] * 3 * F32


def serve_roi(cfg: dict):
    """(D, H, W) of the attention stage's padded window."""
    serve = cfg["serve"]
    roi = serve["roi"] or cfg["volume"]
    roi = [min(r, v) for r, v in zip(roi, cfg["volume"])]
    x, y, z = (-(-v // 16) * 16 for v in roi)
    return (z, y, x), roi


def serve(cfg: dict) -> dict:
    """Work of one served volume."""
    dhw, roi = serve_roi(cfg)
    sal = saliency_forward(cfg["saliency"], dhw, cfg["serve"]["sa_gate_stride"])
    n = cfg["pointseg"]["num_points"]
    att_bytes = (cfg["channels"] * math.prod(roi) * F32
                 + sal["params"] * BF16 + math.prod(cfg["volume"]) * BOOL)
    return {"attention_ops": sal["ops"], "attention_bytes": att_bytes,
            "pointnet_ops": pointnet_forward(cfg["pointseg"], n),
            "pyramid_bytes": pyramid_bytes(cfg["pointseg"], n)}


def train_point(cfg: dict) -> dict:
    """Model operations of one point-net train step: forward and backward
    (twice the forward) of each cloud of the batch."""
    p = cfg["pointseg"]
    return {"step_ops": 3 * p["batch_size"] * pointnet_forward(p, p["num_points"])}


def train_saliency(cfg: dict) -> dict:
    """Model operations of one saliency train step (recomputation of the
    checkpointed blocks not counted)."""
    s = cfg["saliency"]
    fwd = saliency_forward(s, s["patch_size"], s["sa_gate_stride"])["ops"]
    return {"step_ops": 3 * s["batch_size"] * fwd}
