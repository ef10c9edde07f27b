"""BraTS case discovery and loading for serving (``pointunet_tpu/data/loader.py``).

Only what ``cli/serve.py`` needs: ``find_brats_cases`` and the uncropped,
label-free load of ``load_brats_case(..., with_label=False, crop=False)``,
returned in the fused pipeline's (C, X, Y, Z) layout. Each modality is
z-scored over its nonzero voxels in the reference's [z, y, x] traversal,
so the result equals the reference's bit for bit
(tests/test_torch_data.py).
"""
from __future__ import annotations

import os
from typing import List

import numpy as np

from . import nifti

BRATS_MODALITIES = ("t1ce", "t1", "flair", "t2")


def find_brats_cases(basedir: str) -> List[str]:
    """Case dirs: <base>/<case>/ or <base>/{HGG,LGG}/<case>/ containing
    <case>_<mod>.nii.gz files."""
    cases = []
    for sub in sorted(os.listdir(basedir)):
        path = os.path.join(basedir, sub)
        if not os.path.isdir(path):
            continue
        if sub in ("HGG", "LGG"):
            for case in sorted(os.listdir(path)):
                if os.path.isdir(os.path.join(path, case)):
                    cases.append(os.path.join(path, case))
        elif any(
            os.path.exists(os.path.join(path, f"{sub}_{m}.nii.gz"))
            for m in BRATS_MODALITIES
        ):
            cases.append(path)
    return cases


def _normalize_nonzero(volume: np.ndarray) -> np.ndarray:
    """Z-score over nonzero voxels; zero voxels stay zero."""
    volume = np.asarray(volume, dtype=np.float32)
    pixels = volume[volume > 0]
    if pixels.size == 0:
        return np.zeros_like(volume)
    out = (volume - pixels.mean()) / max(float(pixels.std()), 1e-8)
    out[volume == 0] = 0.0
    return out


def load_brats_volume(case_dir: str) -> np.ndarray:
    """-> (C, X, Y, Z) float32 modalities, each z-scored over its nonzero
    voxels, in ``BRATS_MODALITIES`` order."""
    case_id = os.path.basename(case_dir.rstrip("/"))
    mods = np.stack([
        nifti.load(
            os.path.join(case_dir, f"{case_id}_{mod}.nii.gz")
        ).get_fdata().astype(np.float32)
        for mod in BRATS_MODALITIES
    ])
    # normalise in [z, y, x] order, as the reference does: the nonzero
    # voxels are summed in that order, which fixes the statistics' rounding
    zyx = np.stack([
        _normalize_nonzero(m) for m in np.transpose(mods, (0, 3, 2, 1))
    ])
    return np.transpose(zyx, (0, 3, 2, 1))
