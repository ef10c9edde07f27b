"""Evaluation metrics (``pointunet_tpu/train/metrics.py``): numpy and
scipy on the host.

Confusion matrices, per-class IoU with the reference's absent-class fill,
mean IoU, binary and per-class Dice, and the BraTS composite regions (WT
= labels {1, 2, 4}, TC = {1, 4}, ET = {4}) with their Dice and HD95 (the
95th percentile of the symmetric surface distances, by scipy's Euclidean
distance transform).
"""
from __future__ import annotations

from typing import Dict

import numpy as np


def confusion_matrix(
    labels: np.ndarray, preds: np.ndarray, num_classes: int
) -> np.ndarray:
    """(C, C) with rows = truth, cols = prediction."""
    labels = np.asarray(labels).reshape(-1)
    preds = np.asarray(preds).reshape(-1)
    idx = labels * num_classes + preds
    return np.bincount(idx, minlength=num_classes * num_classes).reshape(
        num_classes, num_classes
    )


def iou_from_confusion(conf: np.ndarray) -> np.ndarray:
    """Per-class IoU from a (..., C, C) confusion stack; a class absent
    from the truth takes the mean IoU of the present ones."""
    conf = np.asarray(conf, dtype=np.float64)
    tp = np.diagonal(conf, axis1=-2, axis2=-1)
    tp_fn = conf.sum(axis=-1)
    tp_fp = conf.sum(axis=-2)
    iou = tp / (tp_fp + tp_fn - tp + 1e-6)
    mask = tp_fn < 1e-3
    counts = np.sum(1 - mask, axis=-1, keepdims=True)
    miou = np.sum(iou, axis=-1, keepdims=True) / (counts + 1e-6)
    return iou + mask * miou


def mean_iou(labels, preds, num_classes: int) -> float:
    conf = confusion_matrix(labels, preds, num_classes)
    tp = np.diagonal(conf).astype(np.float64)
    denom = conf.sum(0) + conf.sum(1) - tp
    return float(np.mean(tp / np.maximum(denom, 1e-6)))


def binary_dice(pred: np.ndarray, truth: np.ndarray) -> float:
    """2|A∩B| / (|A|+|B|); 1.0 when both are empty."""
    pred = np.asarray(pred) > 0
    truth = np.asarray(truth) > 0
    denom = pred.sum() + truth.sum()
    if denom == 0:
        return 1.0
    return float(2.0 * np.logical_and(pred, truth).sum() / denom)


def per_class_dice(
    pred: np.ndarray, truth: np.ndarray, num_classes: int
) -> np.ndarray:
    return np.asarray(
        [binary_dice(pred == c, truth == c) for c in range(num_classes)]
    )


# BraTS composite tumour regions over the original labels {0, 1, 2, 4}
_BRATS_REGIONS = {
    "WT": (1, 2, 4),
    "TC": (1, 4),
    "ET": (4,),
}


def brats_region_dice(pred: np.ndarray, truth: np.ndarray) -> Dict[str, float]:
    """WT/TC/ET Dice over original BraTS labels (4 = enhancing)."""
    out = {}
    for name, labs in _BRATS_REGIONS.items():
        out[name] = binary_dice(np.isin(pred, labs), np.isin(truth, labs))
    return out


def hausdorff95(pred: np.ndarray, truth: np.ndarray, spacing=None) -> float:
    """95th-percentile symmetric surface distance by distance transforms:
    0.0 when both masks are empty, inf when exactly one is (the BraTS
    convention)."""
    from scipy import ndimage

    pred = np.asarray(pred) > 0
    truth = np.asarray(truth) > 0
    if not pred.any() and not truth.any():
        return 0.0
    if not pred.any() or not truth.any():
        return float("inf")

    def surface(mask):
        return mask & ~ndimage.binary_erosion(mask)

    sp = surface(pred)
    st = surface(truth)
    dt_truth = ndimage.distance_transform_edt(~st, sampling=spacing)
    dt_pred = ndimage.distance_transform_edt(~sp, sampling=spacing)
    all_d = np.concatenate([dt_truth[sp], dt_pred[st]])
    return float(np.percentile(all_d, 95))


def brats_region_hd95(pred: np.ndarray, truth: np.ndarray) -> Dict[str, float]:
    out = {}
    for name, labs in _BRATS_REGIONS.items():
        out[name] = hausdorff95(np.isin(pred, labs), np.isin(truth, labs))
    return out
