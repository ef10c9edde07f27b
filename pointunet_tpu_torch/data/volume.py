"""Volume preprocessing on the host (``pointunet_tpu/data/volume.py``):
numpy only, a copy of the reference's functions.

Intensity normalisation (BraTS: z-score over the nonzero voxels;
Pancreas: over the whole volume, or the HU window), the brain bounding
box and crop, and zero-padded patch extraction and insertion.
"""
from __future__ import annotations

import numpy as np


def intensity_normalize_nonzero(volume: np.ndarray) -> np.ndarray:
    """Z-score over nonzero voxels; zero voxels stay zero."""
    volume = np.asarray(volume, dtype=np.float32)
    pixels = volume[volume > 0]
    if pixels.size == 0:
        return np.zeros_like(volume)
    out = (volume - pixels.mean()) / max(float(pixels.std()), 1e-8)
    out[volume == 0] = 0.0
    return out


def intensity_normalize_full(volume: np.ndarray) -> np.ndarray:
    """Z-score over the full volume (the Pancreas preparation's)."""
    volume = np.asarray(volume, dtype=np.float32)
    return (volume - volume.mean()) / max(float(volume.std()), 1e-8)


def rescale_pancreas_hu(volume: np.ndarray, low=-100.0, high=240.0) -> np.ndarray:
    """Clip HU to [low, high] and scale to [0, 1]."""
    v = np.clip(np.asarray(volume, np.float32), low, high)
    return (v - low) / (high - low)


def nonzero_bbox(mask: np.ndarray, margin: int = 5):
    """Per-axis (lo, hi) bounding box of the nonzero voxels, widened by
    ``margin`` and clipped to the volume; the whole volume if none."""
    coords = np.nonzero(mask)
    if coords[0].size == 0:
        return tuple((0, s) for s in mask.shape)
    bbox = []
    for axis, c in enumerate(coords):
        lo = max(int(c.min()) - margin, 0)
        hi = min(int(c.max()) + 1 + margin, mask.shape[axis])
        bbox.append((lo, hi))
    return tuple(bbox)


def crop_brain_region(
    modalities: np.ndarray, label: np.ndarray | None = None, margin: int = 5
):
    """Crop to the bbox of the voxels nonzero in any modality and z-score
    each modality over its nonzero region. Returns (cropped modalities
    (C, d, h, w), weight mask, cropped label, bbox)."""
    modalities = np.asarray(modalities, dtype=np.float32)
    union = (modalities != 0).any(axis=0)
    bbox = nonzero_bbox(union, margin)
    sl = tuple(slice(lo, hi) for lo, hi in bbox)
    cropped = np.stack(
        [intensity_normalize_nonzero(m[sl]) for m in modalities]
    )
    weight = (modalities[(slice(None),) + sl] != 0).any(axis=0).astype(
        np.float32
    )
    lab = None if label is None else np.asarray(label)[sl]
    return cropped, weight, lab, bbox


def extract_roi(volume: np.ndarray, center, patch_size) -> np.ndarray:
    """The ``patch_size`` ROI centred at ``center`` (its start is
    ``center - patch // 2``), zero-padded where it leaves the volume."""
    patch_size = tuple(patch_size)
    out = np.zeros(patch_size, dtype=volume.dtype)
    src, dst = [], []
    for c, p, s in zip(center, patch_size, volume.shape):
        lo = c - p // 2
        src_lo, src_hi = max(lo, 0), min(lo + p, s)
        dst_lo = src_lo - lo
        dst_hi = dst_lo + (src_hi - src_lo)
        src.append(slice(src_lo, src_hi))
        dst.append(slice(dst_lo, dst_hi))
    out[tuple(dst)] = volume[tuple(src)]
    return out


def insert_roi(volume: np.ndarray, patch: np.ndarray, center) -> np.ndarray:
    """A copy of ``volume`` with ``patch`` written back at ``center`` (the
    inverse placement of ``extract_roi``), clipped to the volume."""
    out = volume.copy()
    src, dst = [], []
    for c, p, s in zip(center, patch.shape, volume.shape):
        lo = c - p // 2
        dst_lo, dst_hi = max(lo, 0), min(lo + p, s)
        src_lo = dst_lo - lo
        src_hi = src_lo + (dst_hi - dst_lo)
        dst.append(slice(dst_lo, dst_hi))
        src.append(slice(src_lo, src_hi))
    out[tuple(dst)] = patch[tuple(src)]
    return out
