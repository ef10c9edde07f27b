"""Case discovery and loading (``pointunet_tpu/data/loader.py``).

* ``find_brats_cases`` walks ``<base>/<case>/`` or
  ``<base>/{HGG,LGG}/<case>/`` folders of ``<case>_<mod>.nii.gz`` files;
* ``load_brats_case`` gives the saliency trainer's ``VolumeRecord`` in
  [z, y, x] layout (brain crop and per-modality normalisation, the label
  binarised) and a ``meta`` dict (``case_id``, ``original_shape``,
  ``bbox`` when cropped, ``label_full``);
* ``load_brats_volume`` is the serving load: uncropped, label-free, in
  the fused pipeline's (C, X, Y, Z) layout;
* ``find_pancreas_cases`` pairs ``PANCREAS_<ID>.nii.gz`` CTs with
  ``label<ID>.nii.gz`` segmentations; ``load_pancreas_case`` rescales HU.

Each modality is z-scored over its nonzero voxels in the reference's
[z, y, x] traversal, so every result equals the reference's bit for bit
(tests/test_torch_data.py, tests/test_torch_saliency_train.py).
"""
from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from . import nifti
from .sampler import VolumeRecord
from .volume import (
    crop_brain_region,
    intensity_normalize_nonzero,
    rescale_pancreas_hu,
)

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


def load_brats_case(
    case_dir: str, with_label: bool = True, crop: bool = True
) -> Tuple[VolumeRecord, dict]:
    """-> (VolumeRecord in [z, y, x], meta). The record's label is the
    binary salient-vs-background target (label > 0); ``meta["label_full"]``
    keeps the BraTS labels."""
    case_id = os.path.basename(case_dir)
    mods = np.stack([
        nifti.load(
            os.path.join(case_dir, f"{case_id}_{mod}.nii.gz")
        ).get_fdata().astype(np.float32)
        for mod in BRATS_MODALITIES
    ])                                                     # (C, X, Y, Z)
    label = None
    if with_label:
        seg_path = os.path.join(case_dir, f"{case_id}_seg.nii.gz")
        if os.path.exists(seg_path):
            label = nifti.load(seg_path).get_fdata().astype(np.int32)

    mods = np.transpose(mods, (0, 3, 2, 1))                # to [z, y, x]
    if label is not None:
        label = np.transpose(label, (2, 1, 0))

    meta = {"case_id": case_id, "original_shape": mods.shape[1:]}
    if crop:
        mods, weight, label, bbox = crop_brain_region(mods, label)
        meta["bbox"] = bbox
    else:
        mods = np.stack([intensity_normalize_nonzero(m) for m in mods])
        weight = (mods != 0).any(axis=0).astype(np.float32)
    if label is None:
        label = np.zeros(mods.shape[1:], np.int32)
    record = VolumeRecord(mods, weight, (label > 0).astype(np.int32))
    meta["label_full"] = label
    return record, meta


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
        intensity_normalize_nonzero(m)
        for m in np.transpose(mods, (0, 3, 2, 1))
    ])
    return np.transpose(zyx, (0, 3, 2, 1))


def find_pancreas_cases(
    ct_dir: str, label_dir: str, ids: Optional[List[str]] = None
) -> List[Tuple[str, str, str]]:
    """(case_id, CT path, label path) for every ``PANCREAS_<ID>.nii*`` in
    ``ct_dir`` (optionally only ``ids``), in name order."""
    cases = []
    for fname in sorted(os.listdir(ct_dir)):
        if not fname.startswith("PANCREAS_") or ".nii" not in fname:
            continue
        case_id = fname.split("PANCREAS_")[1].split(".nii")[0]
        if ids is not None and case_id not in ids:
            continue
        cases.append(
            (
                case_id,
                os.path.join(ct_dir, fname),
                os.path.join(label_dir, f"label{case_id}.nii.gz"),
            )
        )
    return cases


def load_pancreas_case(
    ct_path: str, label_path: Optional[str] = None
) -> VolumeRecord:
    """One CT as a (1, Z, Y, X) record: HU rescaled to [0, 1], weight 1
    everywhere, the binarised label (zeros when there is none)."""
    img = nifti.load(ct_path).get_fdata().astype(np.float32)
    img = rescale_pancreas_hu(img)
    img = np.transpose(img, (2, 1, 0))[None]               # (1, Z, Y, X)
    if label_path and os.path.exists(label_path):
        label = nifti.load(label_path).get_fdata().astype(np.int32)
        label = np.transpose(label, (2, 1, 0))
    else:
        label = np.zeros(img.shape[1:], np.int32)
    weight = np.ones(img.shape[1:], np.float32)
    return VolumeRecord(img, weight, (label > 0).astype(np.int32))
