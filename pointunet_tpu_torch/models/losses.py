"""Segmentation losses (``pointunet_tpu/models/losses.py``).

Point net: the reference masks ignored points with a static-shape masked
mean, and so does the port. ``weighted_cross_entropy`` divides the
weighted sum by the COUNT of valid points, not by the sum of their
weights, so it is not ``F.cross_entropy(weight=...)``.

Saliency net: V-Net soft dice (squared denominator) over softmax
probabilities, with the per-voxel weight broadcast over the classes, the
generalised (Sudre) dice, and their mixup forms against soft targets.
``saliency_dice_loss`` and ``saliency_dice_loss_mixup`` take the port's
channels-first logits (B, C, D, H, W) (and a mixup target in the same
layout) and compute in f32; the per-sample functions take probabilities
(..., V, C), any leading batch axes.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def _valid_mask_and_remap(
    labels: torch.Tensor, num_classes: int, ignored: Sequence[int]
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mask of non-ignored labels and the ignored-collapsed label remap:
    the remaining labels are renumbered 0.. in order, ignored ones map
    to 0 (and are masked)."""
    valid = torch.ones_like(labels, dtype=torch.bool)
    for ign in ignored:
        valid &= labels != ign
    if ignored:
        table, nxt = [], 0
        for lab in range(num_classes + len(ignored)):
            if lab in ignored:
                table.append(0)
            else:
                table.append(nxt)
                nxt += 1
        labels = torch.tensor(table, device=labels.device)[labels.long()]
    return valid, labels


def weighted_cross_entropy_terms(
    logits: torch.Tensor,       # (..., C)
    labels: torch.Tensor,       # (...,) int
    class_weights: Sequence[float],
    num_classes: int,
    ignored: Sequence[int] = (),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sum of the per-point class-weighted softmax CE over the valid
    points, their count): a data-parallel rank divides its sum by the
    count of the global batch."""
    valid, labels = _valid_mask_and_remap(labels, num_classes, ignored)
    logits = logits.reshape(-1, num_classes)
    labels = labels.reshape(-1).long()
    valid = valid.reshape(-1)
    w = torch.tensor(class_weights, dtype=logits.dtype, device=logits.device)
    ce = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    weighted = ce * w[labels] * valid.to(logits.dtype)
    return weighted.sum(), valid.sum()


def weighted_cross_entropy(
    logits: torch.Tensor,       # (..., C)
    labels: torch.Tensor,       # (...,) int
    class_weights: Sequence[float],
    num_classes: int,
    ignored: Sequence[int] = (),
) -> torch.Tensor:
    """Per-point class-weighted softmax CE, mean over the valid points."""
    total, count = weighted_cross_entropy_terms(
        logits, labels, class_weights, num_classes, ignored)
    return total / count.clamp(min=1)


def point_dice_loss(
    logits: torch.Tensor, labels: torch.Tensor, num_classes: int
) -> torch.Tensor:
    """RandLA-Net's dice variant over raw logits."""
    onehot = F.one_hot(labels.reshape(-1).long(), num_classes).float()
    logits = logits.reshape(-1, num_classes)
    num = 2.0 * (onehot * logits).sum(0)
    den = (logits * logits).sum(0) + onehot.sum(0)
    return 1.0 - (num / (den + 1e-5)).mean()


def point_dice_weighted(
    logits: torch.Tensor,
    labels: torch.Tensor,
    class_weights: Sequence[float] = (4.0, 1.0, 1.0, 1.0),
) -> torch.Tensor:
    """Class-weighted dice over raw logits with the reference's [4,1,1,1]
    default weights."""
    num_classes = len(class_weights)
    onehot = F.one_hot(labels.reshape(-1).long(), num_classes).float()
    logits = logits.reshape(-1, num_classes)
    w = torch.tensor(class_weights, dtype=torch.float32,
                     device=logits.device)[None, :]
    num = 2.0 * (w * onehot * logits).sum(0)
    den = (w * logits * logits).sum(0) + onehot.sum(0)
    return 1.0 - (num / (den + 1e-5)).mean()


def _voxel_weight(weight_map: Optional[torch.Tensor], probs: torch.Tensor):
    """(..., V) weights as (..., V, 1) in the probabilities' type; ones
    when there is no map."""
    if weight_map is None:
        return torch.ones_like(probs[..., :1])
    return weight_map.to(probs.dtype)[..., None]


def soft_dice(
    probs: torch.Tensor,                       # (..., V, C)
    labels: torch.Tensor,                      # (..., V) int
    weight_map: Optional[torch.Tensor] = None,  # (..., V)
) -> torch.Tensor:
    """V-Net soft dice with squared denominator, one value per sample."""
    onehot = F.one_hot(labels.long(), probs.shape[-1]).to(probs.dtype)
    return soft_dice_mixup(probs, onehot, weight_map)


def soft_dice_mixup(
    probs: torch.Tensor,                       # (..., V, C)
    target: torch.Tensor,                      # (..., V, C) soft target
    weight_map: Optional[torch.Tensor] = None,  # (..., V)
) -> torch.Tensor:
    """V-Net soft dice against a soft (mixed one-hot) target."""
    w = _voxel_weight(weight_map, probs)
    num = 2.0 * (w * target * probs).sum(-2)
    den = (w * probs * probs).sum(-2) + (target * w).sum(-2)
    return 1.0 - (num / (den + 1e-5)).mean(-1)


def generalised_dice_loss(
    probs: torch.Tensor,                       # (V, C)
    labels: torch.Tensor,                      # (V,) int
    weight_map: Optional[torch.Tensor] = None,  # (V,)
) -> torch.Tensor:
    """Generalised (Sudre) dice: class weights 1 / |ref|^2; a class absent
    from the reference takes the largest weight of the present ones."""
    onehot = F.one_hot(labels.long(), probs.shape[-1]).to(probs.dtype)
    if weight_map is not None:
        w = _voxel_weight(weight_map, probs)
        onehot = onehot * w
        probs = probs * w
    ref_vol = onehot.sum(0)
    seg_vol = probs.sum(0)
    intersect = (onehot * probs).sum(0)
    present = ref_vol > 0
    weights = torch.where(present, 1.0 / (ref_vol * ref_vol),
                          torch.zeros_like(ref_vol))
    weights = torch.where(present, weights, weights.max())
    num = 2.0 * (weights * intersect).sum()
    den = (weights * (seg_vol + ref_vol)).sum() + 1e-6
    return 1.0 - num / den


def _softmax_voxels(logits: torch.Tensor) -> torch.Tensor:
    """(B, C, D, H, W) logits -> (B, V, C) f32 softmax probabilities."""
    b, c = logits.shape[:2]
    return torch.softmax(logits.float().reshape(b, c, -1), dim=1).transpose(1, 2)


def saliency_dice_loss(
    logits: torch.Tensor,                      # (B, C, D, H, W)
    weight: torch.Tensor,                      # (B, D, H, W) or (B, 1, D, H, W)
    labels: torch.Tensor,                      # (B, D, H, W) int
) -> torch.Tensor:
    """Batch mean of the per-sample weighted soft dice over the softmax."""
    b = logits.shape[0]
    return soft_dice(
        _softmax_voxels(logits), labels.reshape(b, -1), weight.reshape(b, -1)
    ).mean()


def saliency_dice_loss_mixup(
    logits: torch.Tensor,                      # (B, C, D, H, W)
    weight: torch.Tensor,                      # (B, D, H, W)
    target: torch.Tensor,                      # (B, C, D, H, W) mixed one-hot
) -> torch.Tensor:
    """Batch mean of the per-sample mixup dice."""
    b, c = logits.shape[:2]
    return soft_dice_mixup(
        _softmax_voxels(logits),
        target.float().reshape(b, c, -1).transpose(1, 2),
        weight.reshape(b, -1),
    ).mean()
