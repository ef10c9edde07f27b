"""Score predicted segmentations against ground truth, with a CSV report
(``pointunet_tpu/cli/evaluation.py``).

    python -m pointunet_tpu_torch.cli.evaluation --dataset brats|pancreas \
        --path_truth truth/ --path_pred pred/ [--path_report report.csv] \
        [--hd95]

BraTS: the WT/TC/ET Dice of each ``<ID>.nii.gz`` prediction against
``<truth>/<ID>/<ID>_seg.nii.gz`` (or ``<truth>/<ID>_seg.nii.gz``), and
with ``--hd95`` their HD95. Pancreas: binary Dice against
``<truth>/label<ID>.nii.gz``. One CSV row a case; the means are printed.
Host numpy and scipy only.
"""
from __future__ import annotations

import argparse
import csv
import os

import numpy as np

from ..data import nifti
from ..train.metrics import binary_dice, brats_region_dice, brats_region_hd95


def evaluate_brats(path_truth, path_pred, path_report, with_hd95=False):
    rows = []
    for fname in sorted(os.listdir(path_pred)):
        if not fname.endswith(".nii.gz"):
            continue
        case_id = fname[: -len(".nii.gz")]
        truth_path = os.path.join(
            path_truth, case_id, f"{case_id}_seg.nii.gz"
        )
        if not os.path.exists(truth_path):
            truth_path = os.path.join(path_truth, f"{case_id}_seg.nii.gz")
        truth = nifti.load(truth_path).get_fdata().astype(np.int32)
        pred = (
            nifti.load(os.path.join(path_pred, fname))
            .get_fdata()
            .astype(np.int32)
        )
        row = {"ID": case_id}
        row.update(
            {k: round(v, 5) for k, v in brats_region_dice(pred, truth).items()}
        )
        if with_hd95:
            row.update(
                {
                    f"HD95_{k}": round(v, 3)
                    for k, v in brats_region_hd95(pred, truth).items()
                }
            )
        rows.append(row)
        print(row)

    if rows:
        with open(path_report, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=list(rows[0].keys()))
            writer.writeheader()
            writer.writerows(rows)
        means = {
            k: float(np.mean([r[k] for r in rows]))
            for k in rows[0]
            if k != "ID"
        }
        print("means:", {k: round(v, 4) for k, v in means.items()})
        return means
    return {}


def evaluate_pancreas(path_truth, path_pred, path_report):
    rows = []
    for fname in sorted(os.listdir(path_pred)):
        if not fname.endswith(".nii.gz"):
            continue
        case_id = fname[: -len(".nii.gz")]
        truth_path = os.path.join(path_truth, f"label{case_id}.nii.gz")
        truth = nifti.load(truth_path).get_fdata() > 0
        pred = nifti.load(os.path.join(path_pred, fname)).get_fdata() > 0
        dice = binary_dice(pred, truth)
        rows.append({"ID": case_id, "Dice": round(dice, 5)})
        print(rows[-1])
    if rows:
        with open(path_report, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=["ID", "Dice"])
            writer.writeheader()
            writer.writerows(rows)
        mean = float(np.mean([r["Dice"] for r in rows]))
        print(f"mean Dice: {mean:.4f}")
        return mean
    return 0.0


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--dataset", choices=["brats", "pancreas"],
                        default="brats")
    parser.add_argument("--path_truth", type=str, required=True)
    parser.add_argument("--path_pred", type=str, required=True)
    parser.add_argument("--path_report", type=str, default="report.csv")
    parser.add_argument("--hd95", action="store_true")
    args = parser.parse_args(argv)
    if args.dataset == "brats":
        return evaluate_brats(
            args.path_truth, args.path_pred, args.path_report, args.hd95
        )
    return evaluate_pancreas(args.path_truth, args.path_pred,
                             args.path_report)


if __name__ == "__main__":
    main()
