"""Grid subsampling: a voxel-grid downsample of a point cloud
(``pointunet_tpu/ops/subsample.py``).

Each occupied cell of side ``grid_size`` gives one output point at the
barycentre of its members, with their mean features and the majority
label (the lowest class on a tie).

* ``grid_subsample``: host numpy with a dynamic output size, for the
  offline prep tools. The reference takes a native C++ path when one is
  built; the port always runs ``grid_subsample_numpy``, bit-equal to the
  reference's (``native.grid_subsample`` is ported beside it, not taken
  here).
* ``grid_subsample_fixed``: device torch with a static output budget
  (sorted-segment reductions by ``torch.unique``, ``index_add_`` and
  ``scatter_reduce``), for on-device pipelines.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _cell_ids(points: np.ndarray, grid_size: float):
    mins = points.min(axis=0)
    cells = np.floor((points - mins) / grid_size).astype(np.int64)
    dims = cells.max(axis=0) + 1
    return (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]


def grid_subsample(points, features=None, labels=None, grid_size=0.1):
    """Barycentre grid subsampling on the host: sub_points, then
    sub_features and sub_labels when given (the reference wrapper's
    return arity)."""
    return grid_subsample_numpy(points, features, labels, grid_size)


def grid_subsample_numpy(points, features=None, labels=None, grid_size=0.1):
    """``grid_subsample`` in numpy: cells in ascending id, sums in f64."""
    points = np.asarray(points, dtype=np.float32)
    ids = _cell_ids(points, grid_size)
    _, inv, counts = np.unique(ids, return_inverse=True, return_counts=True)
    n_cells = counts.shape[0]

    def seg_mean(values):
        values = np.asarray(values, dtype=np.float64)
        out = np.zeros((n_cells,) + values.shape[1:], dtype=np.float64)
        np.add.at(out, inv, values)
        return (out / counts.reshape(-1, *([1] * (values.ndim - 1)))).astype(
            np.float32
        )

    out = [seg_mean(points)]
    if features is not None:
        out.append(seg_mean(features))
    if labels is not None:
        labels = np.asarray(labels).astype(np.int64).reshape(-1)
        n_classes = int(labels.max()) + 1 if labels.size else 1
        votes = np.zeros((n_cells, n_classes), dtype=np.int64)
        np.add.at(votes, (inv, labels), 1)
        out.append(votes.argmax(axis=1).astype(np.int32))
    return out[0] if len(out) == 1 else tuple(out)


def grid_subsample_fixed(
    points: torch.Tensor,          # (N, 3) f32
    features: torch.Tensor,        # (N, d) f32
    labels: torch.Tensor,          # (N,) int
    grid_size: float,
    max_cells: int,
    num_classes: int,
    valid_mask: Optional[torch.Tensor] = None,
):
    """Grid subsampling on the device with a fixed output budget.

    Returns (sub_points (M, 3), sub_features (M, d), sub_labels (M,)
    int32, cell_valid (M,) bool), M = ``max_cells``, cells in ascending
    cell id. Occupied cells beyond the first ``max_cells`` are dropped;
    unused slots have ``cell_valid`` False and zero points and features.
    Invalid points (``valid_mask`` False) join no cell. A label outside
    [0, num_classes) casts no vote.
    """
    n = points.shape[0]
    dev = points.device
    if valid_mask is None:
        valid_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    vm = valid_mask[:, None]
    mins = torch.where(vm, points, torch.inf).amin(dim=0)
    cells = torch.floor((points - mins) / grid_size).to(torch.int32)
    cells = cells.clamp(min=0)
    # data-dependent grid dims keep the ids inside int32
    dims = torch.where(vm, cells, 0).amax(dim=0) + 1
    ids = (cells[:, 0] * dims[1] + cells[:, 1]) * dims[2] + cells[:, 2]
    ids = torch.where(valid_mask, ids, torch.iinfo(torch.int32).max)

    # segment of each point: the rank of its cell id; invalid points and
    # cells past the budget go to one overflow bucket, dropped at the end
    _, seg = torch.unique(ids, return_inverse=True)
    seg = torch.where(valid_mask, seg.clamp(max=max_cells), max_cells)

    ones = valid_mask.to(torch.float32)
    counts = torch.zeros((max_cells + 1,), dtype=torch.float32,
                         device=dev).index_add_(0, seg, ones)
    safe = counts.clamp(min=1.0)[:, None]

    def seg_mean(v):
        acc = torch.zeros((max_cells + 1, v.shape[1]), dtype=torch.float32,
                          device=dev)
        return acc.index_add_(0, seg, v.float() * ones[:, None]) / safe

    sub_points = seg_mean(points)[:max_cells]
    sub_features = seg_mean(features)[:max_cells]
    lab = labels.long()
    votes = torch.zeros((max_cells + 1) * num_classes, dtype=torch.float32,
                        device=dev)
    in_range = valid_mask & (lab >= 0) & (lab < num_classes)
    votes.scatter_reduce_(
        0, seg * num_classes + lab.clamp(0, num_classes - 1),
        in_range.to(torch.float32), reduce="sum",
    )
    votes = votes.view(max_cells + 1, num_classes)[:max_cells]
    sub_labels = votes.argmax(dim=-1).to(torch.int32)
    cell_valid = counts[:max_cells] > 0
    return sub_points, sub_features, sub_labels, cell_valid
