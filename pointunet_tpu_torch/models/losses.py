"""Point-segmentation losses (``pointunet_tpu/models/losses.py``).

The reference masks ignored points with a static-shape masked mean, and
so does the port. ``weighted_cross_entropy`` divides the weighted sum by
the COUNT of valid points, not by the sum of their weights, so it is not
``F.cross_entropy(weight=...)``. The saliency net's volumetric losses are
not ported yet.
"""
from __future__ import annotations

from typing import Sequence, Tuple

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


def weighted_cross_entropy(
    logits: torch.Tensor,       # (..., C)
    labels: torch.Tensor,       # (...,) int
    class_weights: Sequence[float],
    num_classes: int,
    ignored: Sequence[int] = (),
) -> torch.Tensor:
    """Per-point class-weighted softmax CE, mean over the valid points."""
    valid, labels = _valid_mask_and_remap(labels, num_classes, ignored)
    logits = logits.reshape(-1, num_classes)
    labels = labels.reshape(-1).long()
    valid = valid.reshape(-1)
    w = torch.tensor(class_weights, dtype=logits.dtype, device=logits.device)
    ce = -F.log_softmax(logits, dim=-1).gather(1, labels[:, None])[:, 0]
    weighted = ce * w[labels] * valid.to(logits.dtype)
    return weighted.sum() / valid.sum().clamp(min=1)


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
