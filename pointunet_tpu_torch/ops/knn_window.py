"""The cell-window KNN search of XLA ops (``pointunet_tpu/ops/knn_window.py``).

``knn_cell_window(support, query, k, ...)`` is the reference's search
built from sorts, contiguous windows, a small matmul and top-k, which the
reference's pyramid runs off the TPU and its point-sharded halo search
calls (with ``support_valid`` and a per-axis ``resolution``). It is
ported in plain torch: the reference computes it outside any Pallas
kernel. Not to be confused with ``knn_cuda.knn_cell_window``, kernel 1's
wrapper, which searches clouds already sorted on the pyramid's grid and
returns exact neighbours within the 27 cells.

This search keeps the reference's approximations, so its neighbour sets
are the reference's and not exact ones: support and queries are sorted by
raster cell id over an ``alpha``-scaled grid; each tile of ``tile``
sorted queries reads, for each (dx, dy), one window of ``window`` sorted
support rows starting at the tile's first cell (so a tile whose cells
span more rows than the window misses the rest: ``slack`` sizes it);
candidates are held to the query's 27 cells by their decoded cells;
squared distances come from the expansion 2 q.s - |q|^2 - |s|^2; each
window keeps its best k and the 9 windows merge into the best k (exact
top-k, ties to the lower position, as XLA's top-k off the TPU). Slots
with no candidate take the row's first neighbour (row 0 if none).
Results are (Nq, k) int32 rows of the caller's support, in the caller's
query order.

The pyramid derives its level-0 grid from ``_grid_resolution``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

from .knn import pad_k_columns

# the cell id of an excluded support row and of the window padding: its
# decoded cell never equals a query's cell + (dx, dy)
SENTINEL_ID = 2147480000


def _grid_resolution(n_support: int, alpha: float) -> int:
    r = int(math.ceil(n_support ** (1.0 / 3.0) / alpha))
    return max(r, 2)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _top(vals: torch.Tensor, k: int):
    """(values, positions) of the k largest along the last axis, largest
    first, ties to the lower position (XLA's top-k and argmax)."""
    if k == 1:
        pos = torch.argmax(vals, dim=-1, keepdim=True)
        return vals.gather(-1, pos), pos
    srt, pos = torch.sort(vals, dim=-1, descending=True, stable=True)
    return srt[..., :k], pos[..., :k]


def _knn_window_impl(
    support: torch.Tensor,           # (Ns, 3) f32
    query: torch.Tensor,             # (Nq, 3) f32
    k: int,
    resolution: Union[int, Tuple[int, int, int]],
    tile: int,
    window: int,
    support_valid: Optional[torch.Tensor] = None,   # (Ns,) bool
) -> torch.Tensor:
    dev = support.device
    ns, nq = support.shape[0], query.shape[0]
    if isinstance(resolution, int):
        rx = ry = rz = resolution
    else:
        rx, ry, rz = resolution
    ryz = ry * rz
    n_cells = rx * ryz
    rvec = torch.tensor([rx, ry, rz], dtype=torch.float32, device=dev)
    rmax = torch.tensor([rx - 1, ry - 1, rz - 1], dtype=torch.float32,
                        device=dev)

    if support_valid is None:
        lo, hi = support.amin(0), support.amax(0)
    else:
        # excluded rows must not warp the grid's bounding box
        v = support_valid[:, None]
        lo = torch.where(v, support, torch.inf).amin(0)
        hi = torch.where(v, support, -torch.inf).amax(0)
    span = torch.clamp(hi - lo, min=1e-6)

    def cell_of(pts):
        c = torch.floor((pts - lo) / span * rvec)
        c = torch.minimum(torch.clamp(c, min=0), rmax).to(torch.int32)
        return (c[:, 0] * ry + c[:, 1]) * rz + c[:, 2]

    s_ids = cell_of(support)
    if support_valid is not None:
        s_ids = torch.where(support_valid, s_ids, SENTINEL_ID)
    s_order = torch.argsort(s_ids, stable=True)
    s_ids_sorted = s_ids[s_order]
    s_pts_sorted = support[s_order]
    kept = s_ids_sorted[s_ids_sorted < n_cells].long()
    cell_start = torch.zeros(n_cells + 1, dtype=torch.long, device=dev)
    cell_start[1:] = torch.cumsum(torch.bincount(kept, minlength=n_cells), 0)

    q_ids = cell_of(query)
    q_order = torch.argsort(q_ids, stable=True)
    pad_q = (-nq) % tile
    qp = F.pad(query[q_order], (0, 0, 0, pad_q)).view(-1, tile, 3)
    qi = F.pad(q_ids[q_order], (0, pad_q), value=n_cells - 1).view(-1, tile)

    sp_pad = F.pad(s_pts_sorted, (0, 0, 0, window))
    si_pad = F.pad(s_ids_sorted, (0, window), value=SENTINEL_ID)

    qz, qy, qx = qi % rz, (qi // rz) % ry, qi // ryz
    q_sq = (qp * qp).sum(-1)                              # (nt, T)
    c_lo = qi[:, 0].long()                                # (nt,)
    span_w = torch.arange(window, device=dev)

    all_negd, all_idx = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            off = dx * ryz + dy * rz
            w0 = cell_start[torch.clamp(c_lo + off - 1, 0, n_cells - 1)]
            rows_i = w0[:, None] + span_w                 # (nt, W)
            rows = sp_pad[rows_i]                         # (nt, W, 3)
            rsid = si_pad[rows_i]
            sz, sy, sx = rsid % rz, (rsid // rz) % ry, rsid // ryz
            negd = 2.0 * torch.einsum("ntc,nwc->ntw", qp, rows)
            negd = negd - q_sq[..., None] - (rows * rows).sum(-1)[:, None, :]
            # exact decoded-cell validity; pinning (dx, dy) keeps the 9
            # windows disjoint
            valid = (
                ((sx[:, None, :] - qx[..., None]) == dx)
                & ((sy[:, None, :] - qy[..., None]) == dy)
                & ((sz[:, None, :] - qz[..., None]).abs() <= 1)
            )
            negd = torch.where(valid, negd, -torch.inf)
            vals, pos = _top(negd, min(k, window))
            all_negd.append(vals)
            all_idx.append(w0[:, None, None] + pos)

    negd, pos = _top(torch.cat(all_negd, -1), k)
    idx = torch.cat(all_idx, -1).gather(-1, pos)
    negd = negd.reshape(-1, k)[:nq]
    idx = idx.reshape(-1, k)[:nq]

    found = torch.isfinite(negd)
    orig = torch.where(found, s_order[torch.clamp(idx, 0, ns - 1)], -1)
    first = torch.where(orig[:, :1] >= 0, orig[:, :1], 0)
    orig = torch.where(found & (orig >= 0), orig, first)
    out = torch.empty_like(orig)
    out[q_order] = orig
    return out.to(torch.int32)


def knn_cell_window(
    support: torch.Tensor,
    query: torch.Tensor,
    k: int,
    alpha: float = 1.8,
    tile: int = 128,
    slack: float = 4.0,
    support_valid: Optional[torch.Tensor] = None,
    resolution: Union[int, Tuple[int, int, int], None] = None,
) -> torch.Tensor:
    """The reference's approximate cell-window KNN (see the module
    docstring): (Nq, k) int32 indices into ``support``, nearest first;
    columns beyond the support's size repeat the last
    (``pad_k_columns``). Support first, as the reference's argument
    order. ``support_valid`` (Ns,) bool excludes support rows exactly
    (sentinel cell, outside the grid's box); ``resolution`` overrides the
    grid, per axis as a tuple. Runs on the inputs' device."""
    support = support.float()
    query = query.float()
    ns, nq = int(support.shape[0]), int(query.shape[0])
    k_req, k = k, min(k, ns)
    if resolution is None:
        resolution = _grid_resolution(ns, alpha)
    n_cells = (resolution ** 3 if isinstance(resolution, int)
               else math.prod(resolution))
    tile = min(tile, max(_round_up(nq, 8), 8))
    # expected window rows: the tile's span of support density plus a
    # 2-cell halo
    per_cell = ns / float(n_cells)
    exp_rows = tile * (ns / max(nq, 1)) + 2.0 * per_cell + 64.0
    window = int(_round_up(int(slack * exp_rows), 128))
    window = min(window, _round_up(ns, 128) + 128)
    return pad_k_columns(
        _knn_window_impl(support, query, k, resolution, tile, window,
                         support_valid),
        k_req,
    )
