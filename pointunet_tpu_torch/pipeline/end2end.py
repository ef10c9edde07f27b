"""Reference-exact Point-Unet pipeline: volume -> segmentation
(``pointunet_tpu/pipeline/end2end.py``).

The path the ``segment`` CLI runs without ``--fast``:

  1. saliency attention: the 3-D U-Net over sliding windows of the whole
     volume (``ops/window.py``), softmax, the salient probability;
  2. context-aware sampling on the host: threshold, every voxel with a
     nonzero modality becomes a point, all salient points are kept and
     the budget is filled with random background from one
     ``np.random.Generator`` (``data/pointcloud.py``);
  3. point segmentation: the cell-sorted pyramid (kernel 1 under it) and
     RandLA-Net, softmax, unsorted back to the sampled order;
  4. the probabilities scattered to the voxel grid, argmax, BraTS label 3
     written as 4, and optionally the morphological cleanup.

The models run on ``device`` (the card unless the caller asks for the
CPU); the volume and labels cross to and from the host as numpy.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import PointSegConfig, SaliencyConfig
from ..data.pointcloud import PointCloud, sample_cloud, volume_to_points
from ..ops.pyramid import build_pyramid_batch
from ..ops.scatter import scatter_probs_to_volume
from ..ops.window import sliding_window_inference
from .postprocess import postprocess_brats


class PointUnetPipeline:
    """End-to-end inference over (C, X, Y, Z) modality volumes."""

    def __init__(
        self,
        saliency_model,
        pointseg_model,
        saliency_config: SaliencyConfig,
        pointseg_config: PointSegConfig,
        threshold: float = 0.9,
        seed: int = 0,
        device="cuda",
    ):
        """The models are moved to ``device`` and set to eval mode; the
        sampler draws from ``np.random.default_rng(seed)``, one stream
        across the volumes this pipeline segments, as in the reference."""
        self.device = torch.device(device)
        self.saliency_model = saliency_model.to(self.device).eval()
        self.pointseg_model = pointseg_model.to(self.device).eval()
        self.scfg = saliency_config
        self.pcfg = pointseg_config
        self.threshold = threshold
        self._rng = np.random.default_rng(seed)

    def _volume(self, modalities: np.ndarray) -> torch.Tensor:
        """(C, X, Y, Z) numpy -> (C, Z, Y, X) f32 on the device: the net
        sees [z, y, x] volumes, as in the reference."""
        vol = np.transpose(np.asarray(modalities, np.float32), (0, 3, 2, 1))
        return torch.as_tensor(np.ascontiguousarray(vol), device=self.device)

    @torch.inference_mode()
    def _attention_probs(self, vol: torch.Tensor) -> torch.Tensor:
        """(C, Z, Y, X) -> (num_class, Z, Y, X) f32 averaged softmax."""
        scfg = self.scfg
        return sliding_window_inference(
            vol,
            lambda window: torch.softmax(self.saliency_model(window), dim=1),
            scfg.inference_patch_size,
            (scfg.xstep, scfg.ystep, scfg.zstep),
            scfg.num_class,
        )

    @torch.inference_mode()
    def _binary_mask_xyz(self, vol: torch.Tensor) -> np.ndarray:
        """The thresholded salient mask, (X, Y, Z) uint8 on the host."""
        probs = self._attention_probs(vol)[1]
        return (probs >= self.threshold).permute(2, 1, 0).to(
            torch.uint8
        ).cpu().numpy()

    def attention_map(self, modalities: np.ndarray) -> np.ndarray:
        """Stage 1: (C, X, Y, Z) -> per-voxel salient probability (X, Y, Z)."""
        probs = self._attention_probs(self._volume(modalities))[1]
        return probs.permute(2, 1, 0).cpu().numpy()

    def binary_map(self, modalities: np.ndarray) -> np.ndarray:
        """Stage 1 and the threshold: (X, Y, Z) uint8."""
        return (self.attention_map(modalities) >= self.threshold).astype(
            np.uint8
        )

    def sample(self, modalities: np.ndarray, mask: np.ndarray) -> PointCloud:
        """Stage 2: the fixed-budget cloud, every voxel of ``mask`` kept."""
        cloud = volume_to_points(modalities)
        o = cloud.xyz_origin
        fg = mask[o[:, 0], o[:, 1], o[:, 2]]
        return sample_cloud(cloud, self.pcfg.num_points, self._rng,
                            foreground=fg)

    @torch.inference_mode()
    def _pointseg_probs(self, xyz: torch.Tensor, feats: torch.Tensor):
        """(N, 3), (N, C) -> (N, num_classes) f32 softmax, in input order:
        the net runs on the cell-sorted cloud, its output is unsorted."""
        pcfg = self.pcfg
        pyramid = build_pyramid_batch(
            xyz[None], pcfg.k_n, pcfg.sub_sampling_ratio
        )
        order = pyramid.order[0].long()
        feats_all = torch.cat([xyz, feats], dim=-1)
        dt = self.pointseg_model.compute_dtype(feats_all.device)
        logits = self.pointseg_model(feats_all.to(dt)[order][None], pyramid)
        probs = torch.softmax(logits[0], dim=-1)
        return probs[torch.argsort(order)]

    def segment_points(self, cloud: PointCloud) -> np.ndarray:
        """Stage 3 on a sampled cloud -> (N, num_classes) probabilities."""
        return self._pointseg_probs(
            torch.as_tensor(cloud.xyz, device=self.device),
            torch.as_tensor(cloud.features, device=self.device),
        ).cpu().numpy()

    @torch.inference_mode()
    def segment_volume(
        self,
        modalities: np.ndarray,             # (C, X, Y, Z), normalized
        mask: Optional[np.ndarray] = None,  # precomputed binary map
        brats_labels: bool = True,
        postprocess: bool = False,
    ) -> np.ndarray:
        """The whole path -> (X, Y, Z) uint8 labels."""
        modalities = np.asarray(modalities, np.float32)
        if mask is None:
            mask = self._binary_mask_xyz(self._volume(modalities))
        sampled = self.sample(modalities, mask)
        probs = self._pointseg_probs(
            torch.as_tensor(sampled.xyz, device=self.device),
            torch.as_tensor(sampled.features, device=self.device),
        )
        x, y, z = modalities.shape[1:]
        vol = scatter_probs_to_volume(
            probs, torch.as_tensor(sampled.xyz_origin, device=self.device),
            (z, y, x),
        )
        labels = vol.argmax(dim=-1).to(torch.uint8)      # (Z, Y, X)
        if brats_labels:
            labels[labels == 3] = 4
        labels = labels.permute(2, 1, 0).cpu().numpy()   # (X, Y, Z)
        if postprocess and brats_labels:
            labels = postprocess_brats(labels)
        return labels
