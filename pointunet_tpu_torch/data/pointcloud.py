"""Point clouds and context-aware sampling on the host
(``pointunet_tpu/data/pointcloud.py``): numpy only.

``context_aware_sample`` keeps every foreground point and fills the
budget with random background, making the same ``np.random.Generator``
calls as the reference, so one seed gives the same indices.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class PointCloud(NamedTuple):
    xyz: np.ndarray          # (N, 3) float32, coords normalized by dims
    features: np.ndarray     # (N, C) float32 modality intensities
    labels: np.ndarray       # (N,) int32
    xyz_origin: np.ndarray   # (N, 3) int32 original voxel coords


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
