"""Point clouds and context-aware sampling on the host
(``pointunet_tpu/data/pointcloud.py``): numpy only.

``volume_to_points`` turns every voxel with a nonzero modality into a
point; ``context_aware_sample`` keeps every foreground point and fills
the budget with random background, and ``sample_cloud`` applies it to a
cloud. They make the same ``np.random.Generator`` calls as the
reference, so one seed gives the same points.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class PointCloud(NamedTuple):
    xyz: np.ndarray          # (N, 3) float32, coords normalized by dims
    features: np.ndarray     # (N, C) float32 modality intensities
    labels: np.ndarray       # (N,) int32
    xyz_origin: np.ndarray   # (N, 3) int32 original voxel coords


def volume_to_points(
    modalities: np.ndarray,                # (C, X, Y, Z) normalized intensities
    labels: Optional[np.ndarray] = None,   # (X, Y, Z) int
    mask: Optional[np.ndarray] = None,     # (X, Y, Z) restrict to mask > 0
) -> PointCloud:
    """All voxels with any nonzero modality (optionally inside ``mask``),
    in raster order; xyz is the voxel index divided by the volume's
    extent."""
    modalities = np.asarray(modalities, dtype=np.float32)
    nz = (modalities != 0).any(axis=0)
    if mask is not None:
        nz &= np.asarray(mask) > 0
    coords = np.argwhere(nz)                       # (N, 3) int
    dims = np.asarray(modalities.shape[1:], np.float32)
    xyz = coords.astype(np.float32) / dims
    feats = modalities[:, coords[:, 0], coords[:, 1], coords[:, 2]].T
    if labels is None:
        labs = np.zeros(coords.shape[0], np.int32)
    else:
        labs = np.asarray(labels)[
            coords[:, 0], coords[:, 1], coords[:, 2]
        ].astype(np.int32)
    return PointCloud(
        xyz.astype(np.float32),
        np.ascontiguousarray(feats, dtype=np.float32),
        labs,
        coords.astype(np.int32),
    )


def context_aware_sample(
    labels: np.ndarray,
    num_points: int,
    rng: np.random.Generator,
    foreground: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Indices: all foreground + random background fill, shuffled.
    ``foreground`` defaults to labels > 0. Too much foreground is
    subsampled; too little background is drawn with replacement."""
    labels = np.asarray(labels)
    fg_mask = labels > 0 if foreground is None else np.asarray(foreground) > 0
    fg = np.flatnonzero(fg_mask)
    bg = np.flatnonzero(~fg_mask)

    if fg.size >= num_points:
        idx = rng.choice(fg, size=num_points, replace=False)
    else:
        need = num_points - fg.size
        if bg.size >= need:
            fill = rng.choice(bg, size=need, replace=False)
        elif bg.size + fg.size == 0:
            return np.zeros(num_points, np.int64)
        else:
            pool = bg if bg.size else fg
            fill = rng.choice(pool, size=need, replace=True)
        idx = np.concatenate([fg, fill])
    rng.shuffle(idx)
    return idx


def sample_cloud(
    cloud: PointCloud,
    num_points: int,
    rng: np.random.Generator,
    foreground: Optional[np.ndarray] = None,
) -> PointCloud:
    """Context-aware fixed-budget sampling of a full cloud."""
    idx = context_aware_sample(cloud.labels, num_points, rng, foreground)
    return PointCloud(
        cloud.xyz[idx], cloud.features[idx], cloud.labels[idx],
        cloud.xyz_origin[idx],
    )
