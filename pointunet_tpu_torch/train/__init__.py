"""Training loops of the port (``pointunet_tpu/train``): the reference's
public names."""
from .metrics import (
    binary_dice,
    brats_region_dice,
    brats_region_hd95,
    confusion_matrix,
    hausdorff95,
    iou_from_confusion,
    mean_iou,
    per_class_dice,
)
from .pointseg import PointSegTrainer, TrainState

__all__ = [
    "binary_dice",
    "brats_region_dice",
    "brats_region_hd95",
    "confusion_matrix",
    "hausdorff95",
    "iou_from_confusion",
    "mean_iou",
    "per_class_dice",
    "PointSegTrainer",
    "TrainState",
]
