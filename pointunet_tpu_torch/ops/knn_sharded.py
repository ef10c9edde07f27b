"""Self-KNN of a cloud whose x-slabs lie on different ranks
(``pointunet_tpu/ops/knn_sharded.py``).

Contract, as in the reference: the cloud is sorted by x (``sort_by_x``)
and rank j of the mesh's point group holds the j-th contiguous block of
its rows, an x-slab. No rank holds the whole cloud. Each rank:

1. gets ``halo`` rows on each side of its slab: every rank contributes
   the first and the last ``min(halo, rows)`` rows of its slab to two
   ``all_gather``s, and takes the last ``halo`` rows of the slabs to its
   left and the first ``halo`` of those to its right, over as many slabs
   as that takes (the reference's multi-hop exchange); the edge ranks
   take no wrapped rows;
2. searches [left | own | right] with kernel 1 (``knn_cell_window``),
   its own slab as the queries, on a grid of cubic cells over a cube
   that encloses the support. The slab spans fewer x-cells than y- or
   z-cells; cubic cells keep a true neighbour within one cell in every
   axis, the recall that the reference buys with its per-axis grid
   (``knn_sharded.py:100-107``: 0.947 isotropic, 0.997 cubic);
3. returns the (rows, k) neighbours as global rows of the x-sorted cloud.

Exact where every true neighbour of a slab point lies within ``halo``
rows of the slab's edge and in its 27 cells (``default_halo`` sizes the
halo as the reference does). The reference's only users of this op are
its tests; the port's pyramid shares its searches by query rows
(``ops/pyramid_sharded.py``), with no halo.
"""
from __future__ import annotations

import math

import torch

from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import POINT_AXIS, Mesh
from .knn_cuda import cell_prefix_sums, knn_cell_window
from .knn_window import _round_up

# the largest grid side of the slab search: r^3 + 1 int32 cell starts
R_MAX = 256


def default_halo(n: int, alpha: float = 1.8, slack: float = 4.0) -> int:
    """Rows in one grid-cell x-layer of an n-point cloud on the uniform
    density bound (alpha * n^(2/3)), times ``slack``, rounded up to 128:
    the reference's sizing (slack 4.0, as its forward cell windows)."""
    return _round_up(int(slack * alpha * float(n) ** (2.0 / 3.0)) + 128, 128)


def sort_by_x(xyz: torch.Tensor):
    """(xyz sorted by x, order): ``sorted = xyz[order]``, ties in row
    order."""
    order = torch.argsort(xyz[:, 0], stable=True)
    return xyz[order], order


def cube_grid(support: torch.Tensor, alpha: float):
    """(lo (3,), side, r): an r^3 grid of cubic cells over the cube of
    side ``side`` at ``lo`` that encloses ``support``, with about
    alpha^3 points a cell where the support lies (its bounding box's share
    of the cube sets how many cells it spans)."""
    lo = support.amin(0)
    extent = (support.amax(0) - lo).clamp(min=1e-6).tolist()
    side = max(extent)
    filled = math.prod(extent) / side ** 3
    r = math.ceil((support.shape[0] / filled) ** (1.0 / 3.0) / alpha)
    return lo, side, min(max(r, 2), R_MAX)


def _strips(block: torch.Tensor, sizes, halo: int, j: int, group):
    """(left, right) halo rows of rank j's slab ``block``: the rows of
    the slabs before and after it, at most ``halo`` each."""
    strip = [min(halo, s) for s in sizes]
    heads = all_gather_rows(block[:strip[j]], strip, group)
    tails = all_gather_rows(block[block.shape[0] - strip[j]:], strip, group)
    start = [sum(strip[:i]) for i in range(len(strip) + 1)]
    left = tails[:start[j]][-halo:] if halo else tails[:0]
    right = heads[start[j + 1]:][:halo]
    return left, right


def knn_point_sharded(
    xyz_local: torch.Tensor,      # (rows, 3): this rank's x-slab
    k: int,
    mesh: Mesh,
    halo: int | None = None,
    alpha: float = 1.8,
) -> torch.Tensor:
    """Self-KNN of an x-sorted cloud split over the point group: (rows, k)
    int32 global rows of the x-sorted cloud for this rank's slab (see the
    module docstring). Slabs may differ in length."""
    group = mesh.groups[POINT_AXIS]
    parts, j = mesh.shape[POINT_AXIS], mesh.coords[POINT_AXIS]
    dev = xyz_local.device
    xyz_local = xyz_local.float().contiguous()
    own = torch.tensor([xyz_local.shape[0]], dtype=torch.int64, device=dev)
    sizes = [int(s) for s in all_gather_rows(own, [1] * parts, group)]
    n = sum(sizes)
    if halo is None:
        halo = default_halo(n, alpha)
    left, right = _strips(xyz_local, sizes, halo, j, group)
    support = torch.cat([left, xyz_local, right])
    first = sum(sizes[:j]) - left.shape[0]      # global row of support 0

    lo, side, r = cube_grid(support, alpha)
    c3 = torch.floor((support - lo) / side * r).to(torch.int32).clamp(0, r - 1)
    ids = (c3[:, 0] * r + c3[:, 1]) * r + c3[:, 2]
    s_order = torch.argsort(ids, stable=True)
    cell_start = cell_prefix_sums(ids[s_order], r)
    own_rows = slice(left.shape[0], left.shape[0] + xyz_local.shape[0])
    q_order = torch.argsort(ids[own_rows], stable=True)
    got = knn_cell_window(
        support[s_order].contiguous(), cell_start,
        xyz_local[q_order].contiguous(), c3[own_rows][q_order].contiguous(),
        k, r,
    )
    rows = s_order[got.long()] + first
    out = torch.empty_like(rows)
    out[q_order] = rows
    return out.to(torch.int32)
