"""Multi-level point pyramid (``pointunet_tpu/ops/pyramid.py``).

Per level i: the self-KNN ``neigh_idx[i]`` (N_i, K), the kept subset
(original row < N_i // ratio_i: the input is pre-shuffled, so this is a
random decimation), its neighbour rows ``sub_idx[i]`` (N_{i+1}, K) and the
1-NN of every level-i point in the kept set, ``interp_idx[i]`` (N_i, 1).

Sorted-pyramid contract (as in the reference): every level is stored in
raster-cell-id order of its own grid, the level-0 resolution halved per
level. Each decimated level is re-sorted by its next grid's ids, and the
1-NN up search runs at the parent level's grid, where both sides are
sorted. ``Pyramid.order`` maps sorted level-0 rows to original rows;
row-aligned per-point arrays are gathered with it before they meet
pyramid indices.

Levels above ``GRID_THRESHOLD`` points search with the cell-window KNN
(``knn_cuda.knn_cell_window``: the CUDA kernel on the card, its plain
version on the CPU); smaller levels with the exact brute force. The
integer bookkeeping (cells, stable argsorts, decimation) matches the
reference bit for bit.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Tuple

import torch

from ..core import trace
from .knn import knn
from .knn_cuda import cell_prefix_sums, knn_cell_window
from .knn_window import _grid_resolution

GRID_THRESHOLD = 16_384


class Pyramid(NamedTuple):
    xyz: Tuple[torch.Tensor, ...]        # (N_i, 3) per level, cell-sorted;
                                         #   num_layers + 1 entries
    neigh_idx: Tuple[torch.Tensor, ...]  # (N_i, K)     level-i rows
    sub_idx: Tuple[torch.Tensor, ...]    # (N_{i+1}, K) level-i rows
    interp_idx: Tuple[torch.Tensor, ...] # (N_i, 1)     level-(i+1) rows
    order: torch.Tensor                  # (N_0,) sorted row -> original row


def _level_resolutions(r0: int, n_levels: int) -> Tuple[int, ...]:
    """Per-level grid: the level-0 resolution halved per level, so cell
    coordinates coarsen by bit shift (cells_l = cells_0 >> l)."""
    return tuple(max(((r0 - 1) >> l) + 1, 1) for l in range(n_levels + 1))


def _search_sorted(sp, s_ids, qp, qc3, k, r):
    """Cell-window KNN on pre-sorted clouds: (Nq, k) sorted-support rows."""
    cell_start = cell_prefix_sums(s_ids, r)
    return knn_cell_window(
        sp.contiguous(), cell_start, qp.contiguous(),
        qc3.to(torch.int32).contiguous(), k, r,
    )


class QuerySlab(NamedTuple):
    """The part of a level's searches that this rank runs: the query
    ``rows`` (a slice of the level's sorted rows), and ``gather``, which
    assembles the level's (N_i, k) result from every rank's rows."""
    rows: slice
    gather: Callable[[torch.Tensor], torch.Tensor]


def build_pyramid(
    xyz: torch.Tensor, k: int, ratios: Tuple[int, ...],
    split: Optional[Callable[[int], Optional[QuerySlab]]] = None,
) -> Pyramid:
    """Build the decimation pyramid of one pre-shuffled cloud (N, 3).
    Levels come back cell-sorted (see the module docstring).

    ``split`` (``ops/pyramid_sharded.py``) is called with each level's
    row count: None searches the whole level here; a ``QuerySlab`` runs
    the level's self and up searches for its query rows only, against
    the whole level, and gathers the rest. A query's neighbours do not
    depend on the other queries of a search, so the result is the same
    bit for bit."""
    n = xyz.shape[0]
    for i, r_ in enumerate(ratios):
        n //= r_
        if n < 1:
            raise ValueError(
                f"num_points={xyz.shape[0]} empties the pyramid at level "
                f"{i} (ratios {tuple(ratios)}); need at least "
                f"{math.prod(ratios)} points"
            )

    n0 = xyz.shape[0]
    r0 = _grid_resolution(n0, 1.8)
    rs = _level_resolutions(r0, len(ratios))

    xyz = xyz.float()
    lo = xyz.min(dim=0).values
    span = torch.clamp(xyz.max(dim=0).values - lo, min=1e-6)
    # same f32 operation order as the reference: floor((xyz-lo)/span*r0)
    c3 = torch.floor((xyz - lo) / span * r0).to(torch.int32).clamp(0, r0 - 1)
    ids0 = (c3[:, 0] * r0 + c3[:, 1]) * r0 + c3[:, 2]
    order = torch.argsort(ids0, stable=True).to(torch.int32)

    cur_x = xyz[order.long()]
    cur_c3 = c3[order.long()]
    cur_ord = order

    def shifted(cells3, lvl):
        s, r = lvl, rs[lvl]
        cc = cells3 >> s
        ids = (cc[:, 0] * r + cc[:, 1]) * r + cc[:, 2]
        return cc, ids

    xyzs, neighs, subs, ups = [], [], [], []
    for i, ratio in enumerate(ratios):
        ns_i = cur_x.shape[0]
        n_sub = ns_i // ratio
        grid_search = ns_i > GRID_THRESHOLD
        slab = split(ns_i) if split is not None else None
        q = slice(None) if slab is None else slab.rows
        if grid_search:
            cc, ids = shifted(cur_c3, i)
            neigh = _search_sorted(cur_x, ids, cur_x[q], cc[q], k, rs[i])
        else:
            neigh = knn(cur_x, cur_x[q], k)
        if slab is not None:
            neigh = slab.gather(neigh)
        # decimation: original row < n_sub; cur_ord is a permutation, so
        # exactly n_sub rows, kept in this level's sort order
        idx_rel = torch.nonzero(cur_ord < n_sub).squeeze(1)
        trace.count("host_sync")         # nonzero reads its size back
        sub_x = cur_x[idx_rel]
        sub_c3 = cur_c3[idx_rel]
        xyzs.append(cur_x)
        neighs.append(neigh)
        sub_neigh = neigh[idx_rel]
        if grid_search:
            # 1-NN at the PARENT level's grid, where the compacted sub
            # cloud and the queries are both sorted
            _, sids = shifted(sub_c3, i)
            qcc, _ = shifted(cur_c3, i)
            up = _search_sorted(sub_x, sids, cur_x[q], qcc[q], 1, rs[i])
        else:
            up = knn(sub_x, cur_x[q], 1)
        if slab is not None:
            up = slab.gather(up)
        # re-sort the decimated level by its own grid's ids; up values are
        # remapped into the re-sorted row space
        _, sids_next = shifted(sub_c3, i + 1)
        s_sort = torch.argsort(sids_next, stable=True)
        inv = torch.empty(n_sub, dtype=torch.int32, device=xyz.device)
        inv[s_sort] = torch.arange(n_sub, dtype=torch.int32, device=xyz.device)
        subs.append(sub_neigh[s_sort])
        ups.append(inv[up.long()])
        cur_x = sub_x[s_sort]
        cur_c3 = sub_c3[s_sort]
        cur_ord = cur_ord[idx_rel][s_sort]
    xyzs.append(cur_x)
    return Pyramid(tuple(xyzs), tuple(neighs), tuple(subs), tuple(ups), order)


def build_pyramid_batch(
    xyz: torch.Tensor, k: int, ratios: Tuple[int, ...], split=None
) -> Pyramid:
    """(B, N, 3) -> Pyramid with a leading batch dim on every leaf
    (``split`` as in ``build_pyramid``)."""
    pyrs = [build_pyramid(x, k, ratios, split) for x in xyz]
    return Pyramid(*(
        tuple(torch.stack(level) for level in zip(*field))
        if isinstance(field[0], tuple) else torch.stack(field)
        for field in zip(*pyrs)
    ))


def take_level0(pyramid: Pyramid, *arrays):
    """Gather row-aligned per-point arrays into the pyramid's level-0
    (cell-sorted) order: ``arr[pyramid.order]``, batched if needed."""
    order = pyramid.order.long()
    if order.ndim == 2:   # batched pyramid
        out = tuple(
            torch.stack([a_b[o_b] for a_b, o_b in zip(a, order)])
            for a in arrays
        )
    else:
        out = tuple(a[order] for a in arrays)
    return out if len(out) != 1 else out[0]
