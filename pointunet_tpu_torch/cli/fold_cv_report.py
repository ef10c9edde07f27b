"""Accuracy, IoU and mean accuracy of predicted against original point
clouds (``pointunet_tpu/cli/fold_cv_report.py``).

    python -m pointunet_tpu_torch.cli.fold_cv_report --pred_path pred/ \
        --original_path original_ply/ [--num_classes 4]

Each ``<pred_path>/<ID>.ply`` carries a ``pred`` field and its namesake
under ``--original_path`` a ``class`` field. Prints each cloud's
accuracy, then the overall accuracy, mean IoU, per-class IoU and mean
accuracy of the pooled confusion matrix. Host numpy only.
"""
from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from ..data.ply import read_ply
from ..train.metrics import confusion_matrix


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--pred_path", type=str, required=True)
    parser.add_argument("--original_path", type=str, required=True)
    parser.add_argument("--num_classes", type=int, default=4)
    args = parser.parse_args(argv)

    conf = np.zeros((args.num_classes, args.num_classes), np.int64)
    total_correct = total_seen = 0
    for path in sorted(glob.glob(os.path.join(args.pred_path, "*.ply"))):
        pred = read_ply(path)["pred"].astype(np.int64)
        name = os.path.basename(path)
        original = read_ply(os.path.join(args.original_path, name))
        labels = original["class"].astype(np.int64)
        correct = int((pred == labels).sum())
        print(f"{name[:-4]}_acc: {correct / len(labels):.4f}")
        total_correct += correct
        total_seen += len(labels)
        conf += confusion_matrix(labels, pred, args.num_classes)

    tp = np.diagonal(conf).astype(np.float64)
    gt = conf.sum(axis=1)
    pos = conf.sum(axis=0)
    iou = tp / np.maximum(gt + pos - tp, 1)
    acc = tp / np.maximum(gt, 1)
    print(f"eval accuracy: {total_correct / max(total_seen, 1):.4f}")
    print(f"mean IOU: {iou.mean():.4f}")
    print("per-class IoU:", [round(v, 4) for v in iou])
    print(f"mAcc value is : {acc.mean():.4f}")


if __name__ == "__main__":
    main()
