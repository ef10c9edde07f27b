"""Evaluation metrics (``pointunet_tpu/train/metrics.py``): numpy only.

The point trainer's part: confusion matrices, per-class IoU with the
reference's absent-class fill, mean IoU and per-class Dice.
"""
from __future__ import annotations

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
