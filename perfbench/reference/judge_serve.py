"""Judge of a served volume: the program's outputs against the plain
reference, worked out again from the same volume and weights.

Numbers compared (``limits/<workload>.json`` holds each limit):

* ``prob_dist``: the attention stage's tumour probabilities in the window
  against the reference's float32 ones, ||p - p_ref|| / ||p_ref||;
* ``mask_faults``: voxels where the stage's mask is not its own
  probabilities' threshold placed at the reference's window (the mask's
  flips against the reference's own mask follow the probabilities'
  rounding and do not separate bf16 from fp8 over seeds);
* ``cloud_faults``: sampled points that break the sampling rule, given the
  stage's mask: out of the volume, repeated, xyz or features not the
  voxel's, or a voxel of a lower tier (salient > other non-empty > empty)
  taken while one of a higher tier is left out;
* ``knn_faults``: rows of the pyramid that differ from the reference's
  pyramid of the same cloud: the level-0 order and each level's points
  bit for bit; each self, kept-point and nearest-kept neighbour set by its
  sorted distances (a neighbour swapped for one at the same distance is
  no fault);
* ``logit_dist``: the point net's logits against the reference's float32
  ones over the reference's pyramid, ||l - l_ref|| over the norm of the
  reference's logits less each class's mean;
* ``scatter_faults``: voxels whose served label is not the argmax of the
  program's logits at that point (BraTS writes class 3 as 4), or is not
  background off the cloud.

The control (``control_one``: the reference in fp8 in the program's
place) is held to ``prob_dist`` and ``logit_dist``; the counts are exact
(limit 0) and planted faults read above it.

The judge imports nothing of the program: it reads the program's tensors
by field name.
"""
from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F

from . import pyramid as ref_pyramid
from . import randlanet, saliency
from .precision import F32, FP8, strict_f32

COUNTS = ("mask_faults", "cloud_faults", "knn_faults", "scatter_faults")
# distances that differ by less than this share of a row's farthest are a
# tie broken by rounding: the voxel grid's distances tie, and one f32
# rounding of a sum of squares moves them by a few parts in 1e7
KNN_RTOL = 1e-5


def roi_box(mods: torch.Tensor, roi, volume):
    """(starts, sizes) (X, Y, Z) of the attention window: ``roi`` centred
    on the non-empty voxels' span of each axis, clamped into the volume;
    the whole volume without ``roi``."""
    if roi is None:
        return (0, 0, 0), tuple(volume)
    present = (mods != 0).any(0)
    starts, sizes = [], []
    for ax, (n, r) in enumerate(zip(volume, roi)):
        r = min(r, n)
        others = tuple(a for a in range(3) if a != ax)
        idx = torch.nonzero(present.any(dim=others[1]).any(dim=others[0]))
        if idx.numel():
            centre = (int(idx.min()) + int(idx.max()) + 1) // 2
        else:
            centre = n // 2
        starts.append(min(max(centre - r // 2, 0), max(n - r, 0)))
        sizes.append(r)
    return tuple(starts), tuple(sizes)


def attention_probs(cfg, w, mods, box, prec=F32()):
    """Tumour probabilities (Z, Y, X) of the window ``box``."""
    (sx, sy, sz), (rx, ry, rz) = box
    win = mods[:, sx:sx + rx, sy:sy + ry, sz:sz + rz].permute(0, 3, 2, 1)
    pad = [(-(-n // 16) * 16) - n for n in (rx, ry, rz)]
    win = F.pad(win[None].float(), (0, pad[0], 0, pad[1], 0, pad[2]))
    s = dict(cfg["saliency"], sa_gate_stride=cfg["serve"]["sa_gate_stride"])
    with torch.no_grad():
        logits = saliency.forward(w, s, win, prec)
    return torch.softmax(logits, 1)[0, 1, :rz, :ry, :rx]


def volume_mask(probs, box, volume, threshold):
    (sx, sy, sz), (rx, ry, rz) = box
    out = torch.zeros(tuple(volume), dtype=torch.bool, device=probs.device)
    out[sx:sx + rx, sy:sy + ry, sz:sz + rz] = (probs >= threshold).permute(2, 1, 0)
    return out


def cloud_faults(mods, mask, cloud, n: int) -> int:
    c, x, y, z = mods.shape
    o = cloud.xyz_origin.long()
    dims = torch.tensor([x, y, z], device=o.device)
    outside = ((o < 0) | (o >= dims)).any(1)
    faults = int(outside.sum()) + abs(o.shape[0] - n)
    o = torch.minimum(o.clamp(min=0), dims - 1)
    flat = (o[:, 0] * y + o[:, 1]) * z + o[:, 2]
    faults += o.shape[0] - int(torch.unique(flat).numel())
    faults += int((cloud.xyz.float() != o.float() / dims.float()).any(1).sum())
    table = mods.reshape(c, -1)
    faults += int((cloud.features.float() != table[:, flat].T).any(1).sum())
    nonzero = (table != 0).any(0)
    tier = mask.reshape(-1).float().clamp(0, 2) * nonzero
    cls = (2 * tier + nonzero.float()).long()
    chosen = torch.zeros_like(nonzero)
    chosen[flat] = True
    counts = torch.bincount(cls, minlength=6)
    above, cut = 0, 0
    for k in range(5, -1, -1):
        if above + int(counts[k]) >= n:
            cut = k
            break
        above += int(counts[k])
    faults += int((chosen & (cls < cut)).sum()) + int((~chosen & (cls > cut)).sum())
    return faults


def _d2(query, support, idx):
    d = query[:, None, :] - support[idx]
    return d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]


def _row_faults(support, query, got, want):
    """(rows whose sorted neighbour distances differ from the reference's
    by more than ``KNN_RTOL`` of the row's farthest, the largest relative
    difference of any row)."""
    got = got.long()
    bad = ((got < 0) | (got >= support.shape[0])).any(1)
    got = got.clamp(0, support.shape[0] - 1)
    d_got = _d2(query, support, got).sort(1).values
    d_want = _d2(query, support, want.long()).sort(1).values
    scale = d_want.amax(1, keepdim=True).clamp(min=1e-30)
    rel = ((d_got - d_want).abs() / scale).amax(1)
    return int((bad | (rel > KNN_RTOL)).sum()), float(rel.max())


def pyramid_faults(port, ref):
    """(rows of the program's (batched) pyramid that differ from the
    reference's, the largest relative distance difference of a row)."""
    faults = int((port.order[0].long() != ref.order).sum())
    worst = 0.0
    for i in range(len(ref.neigh)):
        x, x1 = ref.xyz[i], ref.xyz[i + 1]
        faults += int((port.xyz[i][0] != x).any(1).sum())
        for support, query, got, want in (
                (x, x, port.neigh_idx[i][0], ref.neigh[i]),
                (x, x1, port.sub_idx[i][0], ref.sub[i]),
                (x1, x, port.interp_idx[i][0], ref.interp[i])):
            n, rel = _row_faults(support, query, got, want)
            faults += n
            worst = max(worst, rel)
    faults += int((port.xyz[-1][0] != ref.xyz[-1]).any(1).sum())
    return faults, worst


def point_logits(cfg, w, cloud, pyr, prec=F32()):
    """Reference logits (N, C) in the cloud's own row order."""
    p = cfg["pointseg"]
    feats = torch.cat([cloud.xyz, cloud.features], -1).float()[pyr.order]
    with torch.no_grad():
        logits = randlanet.forward(w, p["num_layers"], feats, pyr.xyz, pyr.neigh,
                                   pyr.sub, pyr.interp, prec)
    out = torch.empty_like(logits)
    out[pyr.order] = logits
    return out


def logit_dist(ref_logits, logits) -> float:
    """||l - l_ref|| over the norm of the reference's logits less each
    class's mean (random weights put one large offset on a class)."""
    centred = ref_logits - ref_logits.mean(0)
    return float((logits - ref_logits).norm() / centred.norm())


def scatter_faults(labels, cloud, logits, brats: bool) -> int:
    """Voxels of the served (X, Y, Z) label volume that are not the argmax
    of ``logits`` at a sampled point, or not background elsewhere."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    o = cloud.xyz_origin.long()
    o = torch.minimum(o.clamp(min=0), torch.tensor(labels.shape, device=o.device) - 1)
    served = labels[o[:, 0], o[:, 1], o[:, 2]]
    faults = 0
    if brats:
        faults += int((labels == 3).sum())
        served = torch.where(served == 4, 3, served)
    faults += int((served != logits.argmax(1)).sum())
    return faults + int((labels != 0).sum()) - int((labels[o[:, 0], o[:, 1], o[:, 2]] != 0).sum())


def judge_one(cfg, w, mods, cap) -> Dict[str, float]:
    serve, p = cfg["serve"], cfg["pointseg"]
    volume = cfg["volume"]
    box = roi_box(mods, serve["roi"], volume)
    probs = attention_probs(cfg, w["saliency"], mods, box)
    (rx, ry, rz) = box[1]
    port_probs = torch.softmax(cap["saliency_logits"].float(), 1)[0, 1, :rz, :ry, :rx]
    own_mask = volume_mask(port_probs, box, volume, serve["threshold"])
    out = {"prob_dist": float((port_probs - probs).norm() / probs.norm()),
           "mask_faults": int((own_mask != cap["attention"].bool()).sum())}
    cloud = cap["sampling"]
    out["cloud_faults"] = cloud_faults(mods, cap["attention"], cloud,
                                       p["num_points"])
    pyr = ref_pyramid.build(cloud.xyz, p["k_n"], p["sub_sampling_ratio"])
    port_pyr = cap["pyramid"]
    out["knn_faults"], out["knn_rel_diff"] = pyramid_faults(port_pyr, pyr)
    ref_logits = point_logits(cfg, w["pointseg"], cloud, pyr)
    port_logits = torch.empty_like(ref_logits)
    port_logits[port_pyr.order[0].long()] = cap["point_logits"][0].float()
    out["scatter_faults"] = scatter_faults(cap["labels"], cloud, port_logits,
                                           serve["brats_labels"])
    out["logit_dist"] = logit_dist(ref_logits, port_logits)
    return out


def control_one(cfg, w, mods, cap) -> Dict[str, float]:
    """The readings of the fp8 reference put in the program's place, on the
    program's cloud."""
    serve, p = cfg["serve"], cfg["pointseg"]
    volume = cfg["volume"]
    box = roi_box(mods, serve["roi"], volume)
    (rx, ry, rz) = box[1]
    probs = attention_probs(cfg, w["saliency"], mods, box)
    low = attention_probs(cfg, w["saliency"], mods, box, FP8())
    out = {"prob_dist": float((low - probs).norm() / probs.norm())}
    cloud = cap["sampling"]
    pyr = ref_pyramid.build(cloud.xyz, p["k_n"], p["sub_sampling_ratio"])
    ref_logits = point_logits(cfg, w["pointseg"], cloud, pyr)
    low_logits = point_logits(cfg, w["pointseg"], cloud, pyr, FP8())
    out["logit_dist"] = logit_dist(ref_logits, low_logits)
    return out


def judge(cfg, w, items: List, dev, one=judge_one) -> Dict[str, float]:
    """The numbers over every checked request: counts summed, the others
    their largest."""
    total: Dict[str, float] = {}
    with strict_f32():
        for volume, cap in items:
            mods = torch.as_tensor(volume, device=dev)
            for k, v in one(cfg, w, mods, cap).items():
                total[k] = (total.get(k, 0) + v if k in COUNTS
                            else max(total.get(k, 0), v))
            del mods
    return total
