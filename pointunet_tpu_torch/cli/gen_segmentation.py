"""Scattered probability volumes -> label volumes
(``pointunet_tpu/cli/gen_segmentation.py``).

    python -m pointunet_tpu_torch.cli.gen_segmentation \
        --inPros_path npy/ --outSegment_path seg/ [--pancreas [--threshold T]]

The inputs are the (Z, Y, X, C) ``.npy`` volumes that ``run_brats`` and
``run_pancreas`` write in test mode. BraTS: the argmax, with class 3
written as label 4. Pancreas: the salient channel at or above
``--threshold`` (0.5), from each case's first loop (``*loop_0.npy``)
only. Labels are written (X, Y, Z) as ``<ID>.nii.gz``, aligned with the
source volumes. Host numpy only.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..data import nifti


def brats_labels_from_probs(prob_zyxc: np.ndarray) -> np.ndarray:
    """argmax, class 3 -> label 4, (Z, Y, X) -> (X, Y, Z) uint8."""
    seg = prob_zyxc.argmax(-1).astype(np.uint8)
    seg[seg == 3] = 4
    return np.transpose(seg, (2, 1, 0))


def pancreas_labels_from_probs(
    prob_zyxc: np.ndarray, threshold: float
) -> np.ndarray:
    """The salient channel at or above ``threshold``, as (X, Y, Z) uint8."""
    seg = (prob_zyxc[..., 1] >= threshold).astype(np.uint8)
    return np.transpose(seg, (2, 1, 0))


def main_brats(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--inPros_path", type=str, required=True)
    parser.add_argument("--outSegment_path", type=str, required=True)
    args = parser.parse_args(argv)
    os.makedirs(args.outSegment_path, exist_ok=True)
    for fname in sorted(os.listdir(args.inPros_path)):
        if not fname.endswith(".npy"):
            continue
        case_id = fname[: -len(".npy")]
        seg = brats_labels_from_probs(
            np.load(os.path.join(args.inPros_path, fname))
        )
        nifti.save(
            seg, os.path.join(args.outSegment_path, f"{case_id}.nii.gz")
        )
        print(f"{case_id}: labels {np.unique(seg)}")


def main_pancreas(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--inPros_path", type=str, required=True)
    parser.add_argument("--outSegment_path", type=str, required=True)
    parser.add_argument("--threshold", type=float, default=0.5)
    args = parser.parse_args(argv)
    os.makedirs(args.outSegment_path, exist_ok=True)
    for fname in sorted(os.listdir(args.inPros_path)):
        # only the first loop of a case contributes
        if not fname.endswith("loop_0.npy"):
            continue
        case_id = fname.split("_loop_")[0]
        seg = pancreas_labels_from_probs(
            np.load(os.path.join(args.inPros_path, fname)), args.threshold
        )
        nifti.save(
            seg, os.path.join(args.outSegment_path, f"{case_id}.nii.gz")
        )
        print(f"{case_id}: {int(seg.sum())} foreground voxels")


if __name__ == "__main__":
    if "--pancreas" in sys.argv:
        sys.argv.remove("--pancreas")
        main_pancreas()
    else:
        main_brats()
