"""Per-point predictions back into the voxel grid (``pointunet_tpu/ops/scatter.py``).

Point coordinates are voxel indices (x, y, z) of the (X, Y, Z) modality
volume; the output volume is indexed [z, y, x], as in the reference.
"""
from __future__ import annotations

import torch


def scatter_probs_to_volume(
    probs: torch.Tensor,     # (N, C) per-point class probabilities
    xyz: torch.Tensor,       # (N, 3) int voxel coords (x, y, z)
    shape: tuple,            # (Z, Y, X)
) -> torch.Tensor:
    """Scatter per-point probabilities into a (Z, Y, X, C) volume.

    Duplicate coordinates have no defined winner here (``index_put_`` with
    repeated indices); the fused path scatters sampled voxels, which are
    unique.
    """
    xyz = xyz.long()
    vol = torch.zeros(tuple(shape) + (probs.shape[-1],), dtype=probs.dtype,
                      device=probs.device)
    vol[xyz[:, 2], xyz[:, 1], xyz[:, 0]] = probs
    return vol


def scatter_labels_to_volume(
    labels: torch.Tensor,    # (N,) int predicted labels
    xyz: torch.Tensor,       # (N, 3) int voxel coords (x, y, z)
    shape: tuple,            # (Z, Y, X)
) -> torch.Tensor:
    """Scatter per-point labels into a (Z, Y, X) volume (background 0)."""
    xyz = xyz.long()
    vol = torch.zeros(tuple(shape), dtype=labels.dtype, device=labels.device)
    vol[xyz[:, 2], xyz[:, 1], xyz[:, 0]] = labels
    return vol
