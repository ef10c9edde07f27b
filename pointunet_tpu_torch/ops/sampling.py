"""On-device context-aware sampling (``pointunet_tpu/ops/sampling.py``).

Keep all salient voxels, fill the fixed budget with random background
voxels, never pick an empty voxel unless the volume is smaller than the
budget: one top-k over randomised priority scores

  score(v) = U(0,1) + 2 * min(mask(v), 2) * [nonzero] + 1 * [nonzero]

A graded mask (2 = core, 1 = boundary band) puts cores in [5, 6), the band
in [3, 4), background in [1, 2) and empty voxels in [0, 1). The selection
is then permuted, so the pyramid's prefix decimation is an unbiased random
subsample. The random numbers come from an explicit ``torch.Generator``;
they are not the reference's ``jax.random`` stream.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core import trace


class DeviceCloud(NamedTuple):
    xyz: torch.Tensor          # (N, 3) f32, coords / dims
    features: torch.Tensor     # (N, C) f32
    labels: torch.Tensor       # (N,) int32 (zeros if no label volume given)
    xyz_origin: torch.Tensor   # (N, 3) int32 voxel coords


def sample_cloud_device(
    modalities: torch.Tensor,          # (C, X, Y, Z)
    mask: torch.Tensor,                # (X, Y, Z) salient mask (bool/int)
    generator: torch.Generator,        # on the modalities' device
    num_points: int,
    labels: Optional[torch.Tensor] = None,  # (X, Y, Z) int labels
) -> DeviceCloud:
    c, x, y, z = modalities.shape
    nvox = x * y * z
    dev = modalities.device
    flat_mods = modalities.reshape(c, nvox).T              # (nvox, C)
    nonzero = (flat_mods != 0).any(dim=1).float()
    tier = mask.reshape(nvox).float().clamp(0.0, 2.0) * nonzero
    score = (
        torch.rand(nvox, generator=generator, device=dev)
        + 2.0 * tier
        + nonzero
    )
    sel = torch.topk(score, num_points).indices
    # top-k is score-sorted (salient first); shuffle so the prefix
    # decimation downstream is an unbiased random subsample
    perm = torch.randperm(num_points, generator=generator, device=dev)
    sel = sel[perm]

    xi = sel // (y * z)
    rem = sel % (y * z)
    yi = rem // z
    zi = rem % z
    origin = torch.stack([xi, yi, zi], dim=-1).to(torch.int32)
    dims = torch.tensor([x, y, z], dtype=torch.float32, device=dev)
    trace.count("host_sync")             # the list's copy to the device
    xyz = origin.float() / dims

    feats = flat_mods[sel]
    if labels is None:
        labs = torch.zeros(num_points, dtype=torch.int32, device=dev)
    else:
        labs = labels.reshape(nvox)[sel].to(torch.int32)
    return DeviceCloud(xyz, feats, labs, origin)
