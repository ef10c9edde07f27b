"""Segmentation postprocessing on the host (``pointunet_tpu/pipeline/postprocess.py``):
numpy and scipy only.

BraTS: binary closing of the whole-tumour mask, the largest one or two
connected components kept, an enhancing tumour under 100 voxels relabelled
as necrotic core. Pancreas: the largest component, holes filled.
"""
from __future__ import annotations

import numpy as np
from scipy import ndimage


def fill_holes(mask: np.ndarray) -> np.ndarray:
    return ndimage.binary_fill_holes(mask > 0)


def largest_components(mask: np.ndarray, keep: int = 2, min_ratio: float = 0.1):
    """Keep the largest component, plus the second if it is at least
    ``min_ratio`` of the first."""
    labeled, n = ndimage.label(mask > 0)
    if n == 0:
        return mask > 0
    sizes = ndimage.sum(mask > 0, labeled, range(1, n + 1))
    order = np.argsort(sizes)[::-1]
    out = labeled == (order[0] + 1)
    if keep >= 2 and n > 1 and sizes[order[1]] >= min_ratio * sizes[order[0]]:
        out |= labeled == (order[1] + 1)
    return out


def postprocess_pancreas(labels: np.ndarray) -> np.ndarray:
    """Binary CT cleanup: the largest component, holes filled."""
    mask = largest_components(np.asarray(labels) > 0, keep=1)
    return fill_holes(mask).astype(np.uint8)


def postprocess_brats(labels: np.ndarray, et_min_voxels: int = 100) -> np.ndarray:
    """Full BraTS cleanup on a label volume with labels {0, 1, 2, 4}."""
    labels = np.asarray(labels).copy()
    wt = labels > 0
    wt = ndimage.binary_closing(wt)
    wt = largest_components(wt, keep=2)
    labels[~wt] = 0
    # an enhancing tumour this small is probably necrosis
    et = labels == 4
    if 0 < et.sum() < et_min_voxels:
        labels[et] = 1
    return labels
