"""Random 3-D patch sampling for saliency-net training
(``pointunet_tpu/data/sampler.py``): numpy only, the reference's draws.

Random ``patch_size`` crops and three positivity policies for a batch:

  random       — any crops
  one_positive — at least one crop of the batch contains tumour
  all_positive — every crop contains tumour

Records hold (C, D, H, W) volumes on the host. The batches come out in
the reference's channels-last layout, (B, D, H, W, C) images and
(B, D, H, W) weights and labels: from one ``np.random.Generator`` state
they are the reference's arrays bit for bit. The trainer moves the
channels on the device.
"""
from __future__ import annotations

from typing import Iterator, List, Sequence, Tuple

import numpy as np

from .volume import extract_roi


class VolumeRecord:
    """One training case: modalities + weight + label, [z, y, x] layout."""

    def __init__(self, image: np.ndarray, weight: np.ndarray, label: np.ndarray):
        self.image = np.asarray(image, np.float32)     # (C, D, H, W)
        self.weight = np.asarray(weight, np.float32)   # (D, H, W)
        self.label = np.asarray(label, np.int32)       # (D, H, W)


# direction -> (D, H, W) axis permutation of the view a sagittal or
# coronal model of the multi-view ensemble is trained in
_DIRECTION_PERM = {
    "axial": (0, 1, 2),
    "sagittal": (2, 0, 1),
    "coronal": (1, 0, 2),
}


def transpose_record(record: VolumeRecord, direction: str) -> VolumeRecord:
    """View-transposed copy of a record for direction-specific training."""
    perm = _DIRECTION_PERM[direction]
    if perm == (0, 1, 2):
        return record
    return VolumeRecord(
        np.ascontiguousarray(
            np.transpose(record.image, (0,) + tuple(p + 1 for p in perm))
        ),
        np.ascontiguousarray(np.transpose(record.weight, perm)),
        np.ascontiguousarray(np.transpose(record.label, perm)),
    )


def random_patch(
    record: VolumeRecord,
    patch_size: Sequence[int],
    rng: np.random.Generator,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A crop at a random centre; an axis no longer than the patch is
    centred and zero-padded."""
    shape = record.label.shape
    center = []
    for s, p in zip(shape, patch_size):
        if s <= p:
            center.append(s // 2)
        else:
            center.append(int(rng.integers(p // 2, s - p + p // 2 + 1)))
    img = np.stack(
        [extract_roi(c, center, patch_size) for c in record.image]
    )
    weight = extract_roi(record.weight, center, patch_size)
    label = extract_roi(record.label, center, patch_size)
    return img, weight, label


def patch_batches(
    records: List[VolumeRecord],
    patch_size: Sequence[int],
    batch_size: int,
    rng: np.random.Generator,
    sampling: str = "one_positive",
    max_resample: int = 25,
) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Infinite iterator of (B, D, H, W, C) image, (B, D, H, W) weight/label."""
    if not records:
        raise ValueError("no records")
    while True:
        imgs, weights, labels = [], [], []
        batch_has_positive = False
        for b in range(batch_size):
            rec = records[int(rng.integers(len(records)))]
            img, w, lab = random_patch(rec, patch_size, rng)
            need_positive = sampling == "all_positive" or (
                sampling == "one_positive"
                and b == batch_size - 1
                and not batch_has_positive
            )
            tries = 0
            while need_positive and lab.max() <= 0 and tries < max_resample:
                rec = records[int(rng.integers(len(records)))]
                img, w, lab = random_patch(rec, patch_size, rng)
                tries += 1
            batch_has_positive |= lab.max() > 0
            imgs.append(np.moveaxis(img, 0, -1))
            weights.append(w)
            labels.append(lab)
        yield (
            np.stack(imgs),
            np.stack(weights),
            np.stack(labels),
        )


def mixup_batches(batch_iter, num_classes: int, rng, alpha: float = 0.2):
    """Beta mixup of consecutive patch batches: images mix linearly,
    weights take the maximum, labels become mixed one-hot targets
    (B, D, H, W, num_classes)."""
    prev = None
    for images, weights, labels in batch_iter:
        onehot = np.eye(num_classes, dtype=np.float32)[labels]
        if prev is None:
            prev = (images, weights, onehot)
            continue
        lam = float(rng.beta(alpha, alpha))
        pi, pw, po = prev
        yield (
            lam * images + (1 - lam) * pi,
            np.maximum(weights, pw),
            lam * onehot + (1 - lam) * po,
        )
        prev = (images, weights, onehot)
