"""The point budget a dataset needs: the largest |dilate(pred) OR truth|
over its cases (``pointunet_tpu/cli/oversampling_analysis.py``).

    python -m pointunet_tpu_torch.cli.oversampling_analysis \
        --pred_path masks/ --truth_path labels/ [--dilations 1]

For each ground-truth volume (``<name>.nii*``; the case ID is the name
without ``label``), the predicted binary map ``PANCREAS_<ID>.nii.gz`` or
``<ID>.nii.gz`` is dilated ``--dilations`` times (scipy's 6-connected
``binary_dilation``) and joined with the truth; the largest voxel count
is the safe ``--n_point`` for context-aware sampling. Prints each new
largest and the maximum. Host numpy and scipy only.
"""
from __future__ import annotations

import argparse
import os
from typing import Optional, Tuple

import numpy as np
from scipy import ndimage

from ..data import nifti


def dilation_over_truth(pred: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """One dilation of ``pred > 0``, joined with ``truth > 0``."""
    pred = ndimage.binary_dilation(pred > 0)
    return np.logical_or(pred, truth > 0)


def main(argv=None) -> Tuple[int, Optional[str]]:
    """Returns (the largest count, its case ID)."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pred_path", type=str, required=True,
                        help="dir of predicted binary nii.gz maps")
    parser.add_argument("--truth_path", type=str, required=True,
                        help="dir of ground-truth label nii.gz volumes")
    parser.add_argument("--dilations", type=int, default=1)
    args = parser.parse_args(argv)

    n_point, worst = 0, None
    for fname in sorted(os.listdir(args.truth_path)):
        if ".nii" not in fname:
            continue
        case_id = fname.replace("label", "").split(".nii")[0]
        pred_file = os.path.join(args.pred_path, f"PANCREAS_{case_id}.nii.gz")
        if not os.path.exists(pred_file):
            pred_file = os.path.join(args.pred_path, f"{case_id}.nii.gz")
        if not os.path.exists(pred_file):
            print(f"skip {fname}: no prediction")
            continue
        pred = nifti.load(pred_file).get_fdata()
        truth = nifti.load(os.path.join(args.truth_path, fname)).get_fdata()
        mask = pred > 0
        for _ in range(args.dilations):
            mask = ndimage.binary_dilation(mask)
        n = int(np.logical_or(mask, truth > 0).sum())
        if n > n_point:
            n_point, worst = n, case_id
            print(f"{case_id}: {n}")
    print(f"max point budget: {n_point} (case {worst})")
    return n_point, worst


if __name__ == "__main__":
    main()
