"""Point-sharded pyramid (``pointunet_tpu/ops/pyramid_sharded.py``).

Each rank of the mesh's point group builds the same pyramid as
``build_pyramid``, bit for bit, and shares the searches of the large
levels with the other ranks of its group:

* every rank computes the level bookkeeping in full (grid, ``order``,
  decimation, re-sort), as ``build_pyramid`` does: a few arrays of N
  rows, identical on every rank;
* at a level of at least ``shard_min`` rows, rank j of the point group
  takes the contiguous, near-equal range of the level's sorted rows
  ``[j N / P, (j + 1) N / P)`` as queries, runs the level's self search
  (k) and its 1-NN up search for them against the *whole* level (its own
  ``cell_start`` and ``r``: kernel 1 on the card), and the (N_l, k)
  results are all-gathered over the group;
* smaller levels run the same search on every rank.

A query's neighbours do not depend on which other queries share its
search (kernel 1's spans, staged windows and skipped columns are all per
query), so the result is ``build_pyramid``'s in every field.

What is not ported, and why: the reference searches each slab on a grid
of its own, laid over the slab plus a halo fetched from its neighbours
(``ppermute``), padding a level to a multiple of P with masked copies of
its last row. That halo exists for XLA, whose window search builds
(N, window) temporaries and whose global sort would all-gather the cloud;
kernel 1 stages its windows in shared memory, and the cloud is small
(4.4 MB at 365,000 points). Its slab-grid neighbours can also lie outside
the 27 cells of the level's own grid, where the backward's sorted scatter
(kernel 2) would drop their gradient. Padding and masking exist for
static shapes.
"""
from __future__ import annotations

from typing import List, Tuple

import torch

from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import POINT_AXIS, Mesh
from .pyramid import Pyramid, QuerySlab, build_pyramid_batch


def slab_sizes(n: int, parts: int) -> List[int]:
    """Rows of each of ``parts`` contiguous, near-equal ranges of ``n``."""
    return [n * (j + 1) // parts - n * j // parts for j in range(parts)]


def build_pyramid_sharded(
    xyz: torch.Tensor,                # (B, N, 3): this rank's clouds
    k: int,
    ratios: Tuple[int, ...],
    mesh: Mesh,
    *,
    shard_min: int = 32_768,
) -> Pyramid:
    """``build_pyramid_batch`` of this rank's clouds, with the searches of
    every level of at least ``shard_min`` rows split over the mesh's
    point group (see the module docstring). Every rank of the group must
    call it with the same clouds."""
    parts = mesh.shape[POINT_AXIS]
    part = mesh.coords[POINT_AXIS]
    group = mesh.groups[POINT_AXIS]

    def split(n: int):
        if parts == 1 or n < max(shard_min, parts):
            return None
        sizes = slab_sizes(n, parts)
        lo = n * part // parts
        return QuerySlab(
            slice(lo, lo + sizes[part]),
            lambda t: all_gather_rows(t, sizes, group),
        )

    return build_pyramid_batch(xyz, k, ratios, split)
