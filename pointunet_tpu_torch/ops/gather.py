"""Point-cloud gather/pool primitives (``pointunet_tpu/ops/gather.py``).

Unbatched tensors; the model loops over its (tiny) batch. The forward of
the reference's ``sorted_gather`` is a plain row gather, which is what
``gather_neighbour`` is: its custom backward belongs to training.
``RandLANet`` runs its own gathers (kernel 2 in their backward); the
helpers here are plain tensor functions with autograd gradients.
"""
from __future__ import annotations

import torch


def gather_neighbour(features: torch.Tensor, neighbor_idx: torch.Tensor) -> torch.Tensor:
    """(N, d), (M, K) -> (M, K, d)."""
    m, k = neighbor_idx.shape
    rows = features.index_select(0, neighbor_idx.reshape(-1).long())
    return rows.reshape(m, k, features.shape[-1])


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
