"""Grid-bucketed approximate KNN (``pointunet_tpu/ops/knn_grid.py``).

The support is bucketed into a regular grid (sorted by raster cell id,
``alpha`` scaling the cell to the cloud's density); each query scores at
most ``capacity`` rows of each of its 27 neighbouring cells (the first
rows of a cell in sorted order) and keeps the best k. Neighbours farther
than one cell, or beyond a cell's capacity, are missed: the neighbour
sets are the reference's, not exact ones. Queries run in blocks of
``query_block``. Ported in plain torch: the reference computes it with
XLA gathers and sorts, outside any Pallas kernel.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .knn import pad_k_columns
from .knn_window import _grid_resolution


def _knn_grid_impl(
    support: torch.Tensor,       # (Ns, 3) f32
    query: torch.Tensor,         # (Nq, 3) f32
    k: int,
    resolution: int,
    capacity: int,
    query_block: int,
) -> torch.Tensor:
    dev = support.device
    nq = query.shape[0]
    r = resolution
    lo = support.amin(0)
    span = torch.clamp(support.amax(0) - lo, min=1e-6)

    def cell_coords(pts):
        return torch.clamp(torch.floor((pts - lo) / span * r), 0, r - 1).long()

    sc = cell_coords(support)
    s_ids = (sc[:, 0] * r + sc[:, 1]) * r + sc[:, 2]
    order = torch.argsort(s_ids, stable=True)
    sorted_ids = s_ids[order]
    sorted_pts = support[order]
    cell_start = torch.searchsorted(
        sorted_ids, torch.arange(r ** 3 + 1, device=dev))
    offs = torch.stack(torch.meshgrid(
        *(torch.arange(-1, 2, device=dev),) * 3, indexing="ij"), -1).view(27, 3)
    slot = torch.arange(capacity, device=dev)

    pad_q = (-nq) % query_block
    blocks = F.pad(query, (0, 0, 0, pad_q)).view(-1, query_block, 3)
    out = []
    for qb in blocks:
        nc = cell_coords(qb)[:, None, :] + offs              # (Q, 27, 3)
        in_bounds = ((nc >= 0) & (nc < r)).all(-1)
        nc = torch.clamp(nc, 0, r - 1)
        nids = (nc[..., 0] * r + nc[..., 1]) * r + nc[..., 2]
        cand = cell_start[nids][..., None] + slot            # (Q, 27, C)
        valid = (cand < cell_start[nids + 1][..., None]) & in_bounds[..., None]
        cand = torch.where(valid, cand, 0).flatten(1)
        valid = valid.flatten(1)
        diff = sorted_pts[cand] - qb[:, None, :]
        d2 = torch.where(valid, (diff * diff).sum(-1), torch.inf)
        # nearest first, ties to the lower candidate (XLA's argmin and
        # top-k off the TPU)
        if k == 1:
            pos = torch.argmin(d2, dim=1, keepdim=True)
            dk = d2.gather(1, pos)
        else:
            dk, pos = torch.sort(d2, dim=1, stable=True)
            dk, pos = dk[:, :k], pos[:, :k]
        found = torch.isfinite(dk)
        out.append(torch.where(found, order[cand.gather(1, pos)], -1))
    idx = torch.cat(out)[:nq]
    # slots with no candidate repeat the nearest found (row 0 if none)
    first = torch.where(idx[:, :1] >= 0, idx[:, :1], 0)
    return torch.where(idx >= 0, idx, first).to(torch.int32)


def knn_grid(
    support: torch.Tensor,
    query: torch.Tensor,
    k: int,
    alpha: float = 1.8,
    capacity: int = 16,
    query_block: int = 8192,
) -> torch.Tensor:
    """Approximate KNN by spatial hashing (see the module docstring):
    (Nq, k) int32 indices into ``support``, nearest first; columns beyond
    the support's size repeat the last. Arguments as ``ops.knn.knn``;
    larger ``alpha`` means fewer, fuller cells (more exact, more work).
    Runs on the inputs' device."""
    support = support.float()
    query = query.float()
    k_req, k = k, min(k, support.shape[0])
    resolution = _grid_resolution(int(support.shape[0]), alpha)
    query_block = min(query_block, max(int(query.shape[0]), 1))
    return pad_k_columns(
        _knn_grid_impl(support, query, k, resolution, capacity, query_block),
        k_req,
    )
