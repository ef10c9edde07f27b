"""Plain reference of Point-Unet's decimation pyramid.

Per level of a pre-shuffled cloud: sort the points by raster cell id of
the level's grid (the level-0 grid of ``ceil(N^(1/3) / 1.8)`` cells an
axis over the cloud's bounding box, halved per level), search each point's
K neighbours, keep the points whose original row is below N / ratio (a
random decimation, since the input is shuffled), take the kept points'
neighbour rows, search each point's nearest kept point, and re-sort the
kept points by the next grid.

The searches of a level above 16,384 points are the cell-window search
of the system: the exact K nearest among the support points in the 27
cells around the query's cell, nearest first, ties to the lower row, an
empty slot filled with the first neighbour found (row 0 if none). Smaller
levels search exactly over the whole level.
"""
from __future__ import annotations

import math
from typing import List, NamedTuple

import torch

GRID_THRESHOLD = 16_384
CHUNK = 2048


class RefPyramid(NamedTuple):
    xyz: List[torch.Tensor]
    neigh: List[torch.Tensor]
    sub: List[torch.Tensor]
    interp: List[torch.Tensor]
    order: torch.Tensor


def grid_resolution(n: int, alpha: float = 1.8) -> int:
    return max(int(math.ceil(n ** (1.0 / 3.0) / alpha)), 2)


def cell_ids(c3: torch.Tensor, r: int) -> torch.Tensor:
    return (c3[:, 0].long() * r + c3[:, 1]) * r + c3[:, 2]


def window_knn(sp, sc3, qp, qc3, k, r):
    """Cell-window search of cell-sorted support ``sp`` (cells ``sc3``) for
    queries ``qp`` (cells ``qc3``): (Nq, k) int32 support rows."""
    ids = cell_ids(sc3, r)
    start = torch.zeros(r ** 3 + 1, dtype=torch.long, device=sp.device)
    start[1:] = torch.cumsum(torch.bincount(ids, minlength=r ** 3), 0)
    out = torch.zeros((qp.shape[0], k), dtype=torch.int32, device=sp.device)
    offs = torch.tensor([(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)],
                        device=sp.device)
    for q0 in range(0, qp.shape[0], CHUNK):
        q = qp[q0:q0 + CHUNK]
        qc = qc3[q0:q0 + CHUNK].long()
        x = qc[:, :1] + offs[:, 0]
        y = qc[:, 1:2] + offs[:, 1]
        inside = (x >= 0) & (x < r) & (y >= 0) & (y < r)
        z0 = (qc[:, 2:3] - 1).clamp(min=0)
        z1 = (qc[:, 2:3] + 1).clamp(max=r - 1)
        base = (x.clamp(0, r - 1) * r + y.clamp(0, r - 1)) * r
        lo = start[base + z0]
        n = torch.where(inside, start[base + z1 + 1] - lo, 0)   # (Q, 9)
        width = int(n.sum(1).max())
        if width == 0:
            continue
        # candidate j of a query: span s, position j - (sum of spans < s)
        cum = torch.cumsum(n, 1)
        j = torch.arange(width, device=sp.device).expand(q.shape[0], width)
        s = torch.searchsorted(cum, j.contiguous(), right=True).clamp(max=8)
        valid = j < cum[:, -1:]
        row = torch.where(valid, lo.gather(1, s) + j - (cum - n).gather(1, s), 0)
        d = q[:, None, :] - sp[row]
        d2 = torch.where(valid, (d * d).sum(-1), torch.inf)
        # candidates lie in ascending row order, so a stable sort breaks
        # ties to the lower row
        d2s, pos = torch.sort(d2, dim=1, stable=True)
        kk = min(k, width)
        idx = row.gather(1, pos[:, :kk])
        found = torch.isfinite(d2s[:, :kk])
        if kk < k:
            idx = torch.cat([idx, idx.new_zeros((idx.shape[0], k - kk))], 1)
            found = torch.cat([found, found.new_zeros((idx.shape[0], k - kk))], 1)
        first = torch.where(found[:, :1], idx[:, :1], 0)
        out[q0:q0 + CHUNK] = torch.where(found, idx, first).to(torch.int32)
    return out


def exact_knn(sp, qp, k):
    """Exact K nearest over the whole support, nearest first: (Nq, k) int32;
    fewer support points than k repeat the last."""
    kk = min(k, sp.shape[0])
    out = []
    for q0 in range(0, qp.shape[0], CHUNK):
        d = qp[q0:q0 + CHUNK, None, :] - sp[None]
        out.append(torch.topk((d * d).sum(-1), kk, 1, largest=False).indices)
    idx = torch.cat(out).to(torch.int32)
    if kk < k:
        idx = torch.cat([idx, idx[:, -1:].expand(-1, k - kk)], 1)
    return idx


def build(xyz: torch.Tensor, k: int, ratios) -> RefPyramid:
    """The pyramid of one shuffled cloud (N, 3) f32."""
    xyz = xyz.float()
    n0 = xyz.shape[0]
    r0 = grid_resolution(n0)
    rs = [max(((r0 - 1) >> lvl) + 1, 1) for lvl in range(len(ratios) + 1)]
    lo = xyz.min(0).values
    span = torch.clamp(xyz.max(0).values - lo, min=1e-6)
    c3 = torch.floor((xyz - lo) / span * r0).to(torch.int32).clamp(0, r0 - 1)
    order = torch.argsort(cell_ids(c3, r0), stable=True)
    cur_x, cur_c, cur_o = xyz[order], c3[order], order
    xyzs, neighs, subs, ups = [], [], [], []
    for i, ratio in enumerate(ratios):
        n_sub = cur_x.shape[0] // ratio
        grid = cur_x.shape[0] > GRID_THRESHOLD
        cc = cur_c >> i
        if grid:
            neigh = window_knn(cur_x, cc, cur_x, cc, k, rs[i])
        else:
            neigh = exact_knn(cur_x, cur_x, k)
        keep = torch.nonzero(cur_o < n_sub).squeeze(1)
        sub_x, sub_c = cur_x[keep], cur_c[keep]
        if grid:
            up = window_knn(sub_x, sub_c >> i, cur_x, cc, 1, rs[i])
        else:
            up = exact_knn(sub_x, cur_x, 1)
        resort = torch.argsort(cell_ids(sub_c >> (i + 1), rs[i + 1]), stable=True)
        inv = torch.empty_like(resort)
        inv[resort] = torch.arange(n_sub, device=xyz.device)
        xyzs.append(cur_x)
        neighs.append(neigh)
        subs.append(neigh[keep][resort])
        ups.append(inv[up.long()].to(torch.int32))
        cur_x, cur_c, cur_o = sub_x[resort], sub_c[resort], cur_o[keep][resort]
    xyzs.append(cur_x)
    return RefPyramid(xyzs, neighs, subs, ups, order)
