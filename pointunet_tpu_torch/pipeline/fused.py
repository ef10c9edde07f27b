"""Device-resident Point-Unet: one volume on the card -> labels on the card
(``pointunet_tpu/pipeline/fused.py``).

Four stages, each a callable of its own so that they can be timed apart:

  1. ``_attention_mask``: the saliency net in a static ROI window centred
     on the brain's bounding box (padded to the net's depth-5 stride),
     softmax, threshold;
  2. ``_sample``: context-aware sampling, one top-k over random priority
     scores (ops/sampling.py);
  3. ``_pyramid_fn``: the cell-sorted KNN decimation pyramid, whose large
     levels run the CUDA cell-window kernel (ops/pyramid.py);
  4. ``_pointseg_scatter``: the RandLA-Net forward, argmax, and the scatter
     of labels back to the (Z, Y, X) voxel grid.

``segment_device`` chains them; ``segment_batch_device`` runs it over a
batch of volumes, on one card or split over a mesh's data axis;
``segment_volume`` wraps it for numpy (C, X, Y, Z) input and (X, Y, Z)
label output.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import PointSegConfig, SaliencyConfig
from ..ops.pyramid import build_pyramid_batch
from ..ops.sampling import sample_cloud_device
from ..ops.scatter import scatter_labels_to_volume
from ..parallel.collectives import all_gather_rows
from ..parallel.mesh import DATA_AXIS, Mesh, batch_sharding


def _pad_to_multiple(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _roi_start(present: torch.Tensor, size: int, r: int) -> int:
    """Start of a length-``r`` window centred on the span of ``present``,
    clamped into [0, size - r]; an all-false axis centres the window."""
    idx = torch.arange(size, device=present.device)
    first = int(torch.where(present, idx, size).min())
    last = int(torch.where(present, idx, -1).max())
    center = (first + last + 1) // 2
    return min(max(center - r // 2, 0), max(size - r, 0))


def _maxpool3(p: torch.Tensor, width: int) -> torch.Tensor:
    """Separable SAME max filter of size 2*width+1 over a (Z, Y, X) map."""
    d = 2 * width + 1
    p = p[None, None]
    for ax in range(3):
        k = [1, 1, 1]
        pad = [0, 0, 0]
        k[ax], pad[ax] = d, width
        p = F.max_pool3d(p, tuple(k), stride=1, padding=tuple(pad))
    return p[0, 0]


class FusedPointUnet:
    def __init__(
        self,
        saliency_model,
        pointseg_model,
        saliency_config: SaliencyConfig,
        pointseg_config: PointSegConfig,
        threshold: float = 0.9,
        volume_shape=(240, 240, 155),   # (X, Y, Z)
        roi_shape=None,                 # (X, Y, Z) static brain-ROI crop
        att_downscale: int = 1,         # run saliency at 1/s resolution
        mask_dilate: int = 0,           # dilate the salient mask (voxels)
        mask_band: int = 0,             # boundary-band width (voxels)
        band_threshold: float | None = None,
        device="cuda",
    ):
        """Options as in the reference: ``roi_shape`` crops the attention
        stage to a fixed window around the brain; ``att_downscale`` s runs
        the saliency net on an s^3-average-pooled window and resizes the
        probability map back; ``mask_dilate`` grows the thresholded mask;
        ``mask_band`` adds a second, lower sampling tier (the core dilated
        by ``mask_band`` minus the core, plus voxels at or above
        ``band_threshold``, threshold / 4 unless given).
        The models are moved to ``device`` (the card unless the caller
        asks for the CPU) and set to eval mode."""
        self.device = torch.device(device)
        self.saliency_model = saliency_model.to(self.device).eval()
        self.pointseg_model = pointseg_model.to(self.device).eval()
        self.scfg = saliency_config
        self.pcfg = pointseg_config
        self.threshold = threshold
        self.volume_shape = tuple(volume_shape)
        self.att_downscale = int(att_downscale)
        self.mask_dilate = int(mask_dilate)
        self.mask_band = int(mask_band)
        self.band_threshold = (
            threshold / 4.0 if band_threshold is None else float(band_threshold)
        )
        if self.att_downscale < 1:
            raise ValueError(
                f"att_downscale must be >= 1, got {self.att_downscale}"
            )
        if self.mask_dilate < 0:
            raise ValueError(f"mask_dilate must be >= 0, got {self.mask_dilate}")
        if self.mask_band < 0:
            raise ValueError(f"mask_band must be >= 0, got {self.mask_band}")
        if self.mask_band > 0 and self.mask_dilate > 0:
            raise ValueError(
                "mask_band and mask_dilate are mutually exclusive "
                "boundary-recovery modes"
            )
        x, y, z = self.volume_shape
        if roi_shape is None:
            self.roi_shape = None
            self._roi = (x, y, z)
        else:
            self.roi_shape = tuple(
                min(r, d) for r, d in zip(roi_shape, (x, y, z))
            )
            self._roi = self.roi_shape
        s = self.att_downscale
        # the pooled window must still divide the net's depth-5 stride
        self._padded = tuple(_pad_to_multiple(v, 16 * s) for v in self._roi)

    @torch.inference_mode()
    def _attention_mask(self, mods: torch.Tensor) -> torch.Tensor:
        """(C, X, Y, Z) -> (X, Y, Z): bool mask, or a uint8 graded mask
        (2 = core, 1 = band) when ``mask_band`` > 0."""
        x, y, z = self.volume_shape
        rx, ry, rz = self._roi
        xp, yp, zp = self._padded
        s = self.att_downscale
        if self.roi_shape is None:
            roi, sx, sy, sz = mods, 0, 0, 0
        else:
            brain = (mods != 0).any(dim=0)                     # (X, Y, Z)
            sx = _roi_start(brain.any(dim=2).any(dim=1), x, rx)
            sy = _roi_start(brain.any(dim=2).any(dim=0), y, ry)
            sz = _roi_start(brain.any(dim=1).any(dim=0), z, rz)
            roi = mods[:, sx:sx + rx, sy:sy + ry, sz:sz + rz]
        vol = roi.permute(0, 3, 2, 1)[None]                    # (1, C, Z, Y, X)
        vol = F.pad(vol, (0, xp - rx, 0, yp - ry, 0, zp - rz))
        if s > 1:
            vol = F.avg_pool3d(vol, s, s)
        logits = self.saliency_model(vol)                      # (1, 2, Z, Y, X)
        probs = torch.softmax(logits, dim=1)[:, 1:]
        if s > 1:
            probs = F.interpolate(
                probs, size=(zp, yp, xp), mode="trilinear", align_corners=False
            )
        probs = probs[0, 0]                                    # (Z, Y, X)
        if self.mask_dilate > 0:
            probs = _maxpool3(probs, self.mask_dilate)
        if self.mask_band > 0:
            core = probs >= self.threshold
            band = (
                (_maxpool3(probs, self.mask_band) >= self.threshold)
                | (probs >= self.band_threshold)
            ) & ~core
            mask_roi = 2 * core.to(torch.uint8) + band.to(torch.uint8)
        else:
            mask_roi = probs >= self.threshold
        mask_roi = mask_roi[:rz, :ry, :rx].permute(2, 1, 0)    # (X, Y, Z)
        if self.roi_shape is None:
            return mask_roi
        out = torch.zeros((x, y, z), dtype=mask_roi.dtype, device=mods.device)
        out[sx:sx + rx, sy:sy + ry, sz:sz + rz] = mask_roi
        return out

    @torch.inference_mode()
    def _sample(self, mods, mask, generator):
        return sample_cloud_device(mods, mask, generator, self.pcfg.num_points)

    @torch.inference_mode()
    def _pyramid_fn(self, xyz):
        return build_pyramid_batch(
            xyz[None], self.pcfg.k_n, self.pcfg.sub_sampling_ratio
        )

    @torch.inference_mode()
    def _pointseg_scatter(self, pyramid, xyz, feats, origin):
        """Forward on the cell-sorted cloud, argmax, scatter to (Z, Y, X).

        The argmax comes before the scatter: sampled voxels are unique and
        softmax is monotone, so at every written voxel argmax(logits) is
        the label, and unsampled voxels stay 0 (background)."""
        x, y, z = self.volume_shape
        order = pyramid.order[0].long()
        feats_all = torch.cat([xyz, feats], dim=-1)
        dt = self.pointseg_model.compute_dtype(feats_all.device)
        logits = self.pointseg_model(feats_all.to(dt)[order][None], pyramid)
        labels_pt = logits[0].argmax(dim=-1).to(torch.uint8)
        return scatter_labels_to_volume(labels_pt, origin[order], (z, y, x))

    def segment_device(
        self, modalities: torch.Tensor, generator: torch.Generator,
        mask: torch.Tensor = None, return_stages: bool = False,
    ):
        """(C, X, Y, Z) tensor on the device -> (Z, Y, X) uint8 labels.

        A ``mask`` (X, Y, Z) given takes the attention stage's place; with
        ``return_stages``, (labels, the mask, the sampled cloud)."""
        if mask is None:
            mask = self._attention_mask(modalities)
        cloud = self._sample(modalities, mask, generator)
        pyramid = self._pyramid_fn(cloud.xyz)
        labels = self._pointseg_scatter(
            pyramid, cloud.xyz, cloud.features, cloud.xyz_origin
        )
        return (labels, mask, cloud) if return_stages else labels

    def segment_batch_device(
        self,
        modalities: torch.Tensor,     # (B, C, X, Y, Z) on the device
        seeds,                        # B ints
        mesh=None,
    ) -> torch.Tensor:
        """(B, C, X, Y, Z) -> (B, Z, Y, X) uint8 labels: ``segment_device``
        of each volume, volume b drawing its points from a generator
        seeded with ``seeds[b]`` (the reference maps its single-volume
        program over the batch).

        With ``mesh`` (``parallel.mesh.Mesh``), every rank passes the
        whole batch: the volumes are split over the data axis (point ranks
        compute the same ones, as the reference's ``P(data)`` replicates
        them), each rank segments its own, and the labels are gathered
        over the data group, so every rank returns the whole batch, equal
        to the one-card loop."""
        seeds = [int(s) for s in seeds]
        if len(seeds) != modalities.shape[0]:
            raise ValueError(
                f"segment_batch_device: {modalities.shape[0]} volumes and "
                f"{len(seeds)} seeds"
            )
        rows = slice(None)
        if mesh is not None:
            if not isinstance(mesh, Mesh):
                raise TypeError(
                    "segment_batch_device: mesh must be a parallel.mesh.Mesh, "
                    f"got {type(mesh).__name__}"
                )
            rows = batch_sharding(mesh, len(seeds))
        labels = torch.stack([
            self.segment_device(
                m, torch.Generator(device=m.device).manual_seed(s))
            for m, s in zip(modalities[rows], seeds[rows])
        ])
        if mesh is None or mesh.shape[DATA_AXIS] == 1:
            return labels
        return all_gather_rows(
            labels, [labels.shape[0]] * mesh.shape[DATA_AXIS],
            mesh.groups[DATA_AXIS],
        )

    def segment_volume(
        self, modalities: np.ndarray, seed: int = 0, brats_labels: bool = True,
    ) -> np.ndarray:
        """(C, X, Y, Z) numpy -> (X, Y, Z) uint8 labels; with
        ``brats_labels`` in BraTS values (class 3 is written as 4)."""
        mods = torch.as_tensor(
            np.asarray(modalities, np.float32), device=self.device
        )
        gen = torch.Generator(device=self.device).manual_seed(seed)
        labels = self.segment_device(mods, gen).cpu().numpy()
        labels = np.transpose(labels, (2, 1, 0)).copy()
        if brats_labels:
            labels[labels == 3] = 4
        return labels
