"""Point-cloud gather/pool primitives (``pointunet_tpu/ops/gather.py``).

Unbatched tensors; the model loops over its (tiny) batch. The forward of
the reference's ``sorted_gather`` is a plain row gather, which is what
``gather_neighbour`` is: its custom backward belongs to training.
``RandLANet`` runs its own gathers (kernel 2 in their backward); the
helpers here are plain tensor functions with autograd gradients.

``row_sum`` is the gradient of a row gather summed in a fixed order:
every gather of the point net whose backward does not run kernel 2 takes
it (``SortedGather`` below its size gate, the up-sample through
``RowGather``), so that a train step gives the same bits on every run,
as the reference's compiled step does on its TPU. CUDA's ``index_add_``
(the autograd backward of ``index_select``) adds with float atomics, in
whatever order the threads reach a row.
"""
from __future__ import annotations

import torch


def gather_neighbour(features: torch.Tensor, neighbor_idx: torch.Tensor) -> torch.Tensor:
    """(N, d), (M, K) -> (M, K, d)."""
    m, k = neighbor_idx.shape
    rows = features.index_select(0, neighbor_idx.reshape(-1).long())
    return rows.reshape(m, k, features.shape[-1])


def row_sum(rows: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """(R, C) ``rows`` added into (n, C) f32 at their (R,) row ids
    ``idx``: the gradient of ``table[idx]``. Each output row adds its
    terms one after another in ascending position in ``rows`` (a stable
    sort of ``idx``, then ``segment_reduce``'s sum, one thread an output
    element on CUDA), in f32 whatever the rows' type. No atomics: the
    same bits on every launch. The keys are sorted as int32, half the
    radix passes of int64."""
    idx = idx.reshape(-1).int()
    keys, order = torch.sort(idx, stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(n + 1, dtype=torch.int32, device=idx.device))
    rows = rows.reshape(idx.numel(), rows.shape[-1]).index_select(0, order)
    return torch.segment_reduce(rows.float(), "sum", offsets=offsets, axis=0,
                                unsafe=True)


class RowGather(torch.autograd.Function):
    """``table[idx]``, (N, d) and any shape of row ids -> idx.shape + (d,),
    whose backward is ``row_sum`` cast once to the table's type."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.n = table.shape[0]
        rows = table.index_select(0, idx.reshape(-1).long())
        return rows.reshape(*idx.shape, table.shape[-1])

    @staticmethod
    def backward(ctx, ct):
        idx, = ctx.saved_tensors
        return row_sum(ct, idx, ctx.n).to(ct.dtype), None


def max_pool_neighbours(features: torch.Tensor, pool_idx: torch.Tensor) -> torch.Tensor:
    """Max over the K gathered neighbours: (N, d), (M, K) -> (M, d). The
    gradient is shared equally among tied maxima, as ``jnp.max``'s is."""
    return gather_neighbour(features, pool_idx).amax(dim=1)


def nearest_interpolation(features: torch.Tensor, interp_idx: torch.Tensor) -> torch.Tensor:
    """1-NN upsampling gather: (N, d), (M,) or (M, 1) -> (M, d)."""
    return features.index_select(0, interp_idx.reshape(-1).long())


def relative_pos_encoding(xyz: torch.Tensor, neigh_idx: torch.Tensor) -> torch.Tensor:
    """Local spatial encoding: (N, 3), (N, K) -> (N, K, 10), [distance,
    relative xyz, xyz, neighbour xyz]."""
    return encode_neighbor_xyz(xyz, gather_neighbour(xyz, neigh_idx))


def encode_neighbor_xyz(xyz: torch.Tensor, neighbor_xyz: torch.Tensor) -> torch.Tensor:
    """[distance, relative xyz, xyz, neighbour xyz] on pre-gathered
    neighbour coords: (..., N, 3), (..., N, K, 3) -> (..., N, K, 10)."""
    xyz_tile = xyz.unsqueeze(-2).expand(neighbor_xyz.shape)
    relative_xyz = xyz_tile - neighbor_xyz
    relative_dis = torch.sqrt(
        (relative_xyz * relative_xyz).sum(-1, keepdim=True)
    )
    return torch.cat(
        [relative_dis, relative_xyz, xyz_tile, neighbor_xyz], dim=-1
    )
