"""Prepared point-cloud datasets (``pointunet_tpu/data/datasets.py``).

The directory layout of the reference's prep tools:

  <root>/original_ply/<ID>.ply            full clouds (BraTS) or pre-sampled
                                          loops (Pancreas, <ID>_loop_<k>.ply)
  <root>/input0.01/<ID>_xyz_origin.npy    original int voxel coords
                                          (Pancreas: <ID>_xyz_origin_loop_<k>.npy)

Each BraTS epoch samples a fixed budget of points per cloud on the host
(``context_aware_sample``); Pancreas loops were sampled at prep time and
are read whole. Both yield (B=1, N, ...) numpy arrays; the trainer builds
the KNN pyramid on the card.
"""
from __future__ import annotations

import glob
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from ..core.config import (
    PointSegConfig,
    brats_pointseg_config,
    pancreas_pointseg_config,
)
from .ply import read_ply
from .pointcloud import PointCloud, context_aware_sample

BRATS_FEATURES = ("t1ce", "t1", "flair", "t2")
PANCREAS_FEATURES = ("value",)


def _read_cloud(path: str, feature_names) -> PointCloud:
    data = read_ply(path)
    xyz = np.stack([data["x"], data["y"], data["z"]], -1).astype(np.float32)
    feats = np.stack([data[f] for f in feature_names], -1).astype(np.float32)
    labels = data["class"].astype(np.int32)
    return PointCloud(xyz, feats, labels, np.zeros((len(xyz), 3), np.int32))


class PointCloudDataset:
    """Base: a list of (ply path, split) with fixed-budget sampling."""

    feature_names: Tuple[str, ...] = BRATS_FEATURES

    def __init__(self, config: PointSegConfig, seed: int = 0):
        self.cfg = config
        self.rng = np.random.default_rng(seed)
        self.files: Dict[str, List[str]] = {"training": [], "validation": []}

    def _iter_split(
        self, split: str, shuffle: bool, sample: bool = True
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        files = list(self.files[split])
        if shuffle:
            self.rng.shuffle(files)
        for path in files:
            cloud = _read_cloud(path, self.feature_names)
            if sample:
                idx = context_aware_sample(
                    cloud.labels, self.cfg.num_points, self.rng
                )
            else:
                idx = np.arange(len(cloud.labels))
            xyz = cloud.xyz[idx][None]
            feats = np.concatenate([cloud.xyz, cloud.features], -1)[idx][None]
            labels = cloud.labels[idx][None]
            yield xyz, feats, labels

    def train_iter(self):
        return self._iter_split("training", shuffle=True)

    def val_iter(self):
        return self._iter_split("validation", shuffle=False)


class BraTSPointDataset(PointCloudDataset):
    """BraTS: split by ID lists."""

    feature_names = BRATS_FEATURES

    def __init__(
        self,
        root: str,
        train_ids: Optional[List[str]] = None,
        val_ids: Optional[List[str]] = None,
        config: Optional[PointSegConfig] = None,
        seed: int = 0,
    ):
        super().__init__(config or brats_pointseg_config(), seed)
        self.root = root
        self.tree_path = os.path.join(root, "input0.01")
        all_files = sorted(glob.glob(os.path.join(root, "original_ply", "*.ply")))
        train_ids = set(train_ids or [])
        for path in all_files:
            name = os.path.basename(path)[:-4]
            if val_ids is not None:
                split = "validation" if name in val_ids else "training"
                if train_ids and name not in train_ids and split == "training":
                    split = "validation"
            else:
                split = "training" if name in train_ids else "validation"
            self.files[split].append(path)

    def xyz_origin(self, name: str) -> np.ndarray:
        return np.load(os.path.join(self.tree_path, f"{name}_xyz_origin.npy"))

    def test_iter(self):
        """Yield (name, xyz, feats, labels, xyz_origin) for the validation
        clouds, sampled as in training; ``xyz_origin`` rows follow the
        sampled points, for the scatter back into the volume."""
        for path in self.files["validation"]:
            name = os.path.basename(path)[:-4]
            cloud = _read_cloud(path, self.feature_names)
            origin = self.xyz_origin(name)
            idx = context_aware_sample(
                cloud.labels, self.cfg.num_points, self.rng
            )
            feats = np.concatenate([cloud.xyz, cloud.features], -1)
            yield (
                name,
                cloud.xyz[idx][None],
                feats[idx][None],
                cloud.labels[idx][None],
                origin[idx],
            )


class PancreasPointDataset(PointCloudDataset):
    """Pancreas: pre-sampled loops, 4-fold cross-validation; a loop whose
    ID's first four digits are ``fold`` modulo 4 validates."""

    feature_names = PANCREAS_FEATURES

    def __init__(
        self,
        root: str,
        fold: int = 3,
        config: Optional[PointSegConfig] = None,
        seed: int = 0,
    ):
        super().__init__(config or pancreas_pointseg_config(), seed)
        self.root = root
        self.fold = fold
        self.tree_path = os.path.join(root, "input0.01")
        all_files = sorted(glob.glob(os.path.join(root, "original_ply", "*.ply")))
        for path in all_files:
            cloud_id = os.path.basename(path)[:4]
            split = "validation" if int(cloud_id) % 4 == fold else "training"
            self.files[split].append(path)

    def _iter_split(self, split, shuffle, sample=False):
        # the loops were sampled at prep time: read whole, never re-sampled
        return super()._iter_split(split, shuffle, sample=False)

    def xyz_origin(self, name: str) -> np.ndarray:
        base, loop = name.split("_loop_")
        return np.load(
            os.path.join(self.tree_path, f"{base}_xyz_origin_loop_{loop}.npy")
        )

    def test_iter(self):
        """Yield (name, xyz, feats, labels, xyz_origin) for every point of
        each validation loop."""
        for path in self.files["validation"]:
            name = os.path.basename(path)[:-4]
            cloud = _read_cloud(path, self.feature_names)
            origin = self.xyz_origin(name)
            feats = np.concatenate([cloud.xyz, cloud.features], -1)
            yield (
                name,
                cloud.xyz[None],
                feats[None],
                cloud.labels[None],
                origin,
            )
