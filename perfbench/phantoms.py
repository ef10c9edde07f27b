"""Seeded synthetic inputs, made on the device.

* ``volume``: a (C, X, Y, Z) f32 scan. ``brain_mri``: unit noise in an
  ellipsoid brain (the bench's 240x240x155 ellipsoid), zero outside, with
  one ellipsoid tumour of a given voxel count that raises every channel;
  ``abdomen_ct``: tissue noise in an elliptic body cylinder, zero outside
  (air), with one elongated organ blob of a given voxel count.
* ``cloud``: a point-net training cloud as ``cli/profile_train.py``
  makes it, every voxel of a tumour ball (labels 1-3 by shell) plus random
  voxels of the rest of the volume (label 0), shuffled; the ball's centre
  comes from the seed and its radius from the given voxel count.
* ``patches``: saliency training batches (B, D, H, W, C) of noise with
  one labelled blob a patch raising every channel, unit voxel weights.

Sizes are given, positions and noise drawn: every seed does the same work.
"""
from __future__ import annotations

import math

import torch


def _axes(shape, dev):
    ax = [torch.arange(n, device=dev, dtype=torch.float32) for n in shape]
    return torch.meshgrid(*ax, indexing="ij")


def _uniform(g, dev, lo, hi, n=1):
    return (lo + (hi - lo) * torch.rand(n, generator=g, device=dev)).tolist()


def _ellipsoid(xx, yy, zz, centre, radii):
    return sum(((c - m) / r) ** 2 for c, m, r in zip((xx, yy, zz), centre, radii))


def _radii(voxels, g, dev):
    """Radii of an ellipsoid of about ``voxels`` voxels, axis ratios drawn."""
    a = _uniform(g, dev, 0.8, 1.25, 3)
    r = (3.0 * voxels / (4.0 * math.pi * a[0] * a[1] * a[2])) ** (1.0 / 3.0)
    return [r * v for v in a]


def brain_mri(shape, channels, tumour_voxels, g, dev):
    x, y, z = shape
    xx, yy, zz = _axes(shape, dev)
    centre = [x / 2, y / 2 + 2, z / 2 - 1]
    brain = _ellipsoid(xx, yy, zz, centre, (0.31 * x, 0.37 * y, 0.45 * z)) < 1
    t_centre = [c + s * dv for c, s, dv in zip(centre, (x, y, z),
                                               _uniform(g, dev, -0.12, 0.12, 3))]
    tumour = _ellipsoid(xx, yy, zz, t_centre, _radii(tumour_voxels, g, dev)) < 1
    mods = torch.randn((channels,) + tuple(shape), generator=g, device=dev)
    lift = torch.tensor(_uniform(g, dev, 1.0, 2.5, channels), device=dev)
    mods += lift.view(-1, 1, 1, 1) * tumour
    return mods * brain


def abdomen_ct(shape, channels, tumour_voxels, g, dev):
    x, y, z = shape
    xx, yy, _ = _axes(shape, dev)
    body = (((xx - x / 2) / (0.43 * x)) ** 2
            + ((yy - y / 2) / (0.31 * y)) ** 2) < 1
    centre = [x * (0.5 + d) for d in _uniform(g, dev, -0.08, 0.08, 1)]
    centre += [y * 0.55, z * (0.5 + _uniform(g, dev, -0.1, 0.1)[0])]
    xx, yy, zz = _axes(shape, dev)
    r = _radii(tumour_voxels / 3.0, g, dev)
    organ = _ellipsoid(xx, yy, zz, centre, (r[0] * 3.0, r[1], r[2])) < 1
    mods = 0.5 * torch.randn((channels,) + tuple(shape), generator=g, device=dev)
    mods += 0.8 * organ + 0.2
    return mods * body


BODIES = {"brain_mri": brain_mri, "abdomen_ct": abdomen_ct}


def volume(cfg: dict, tumour_voxels: int, g, dev) -> torch.Tensor:
    return BODIES[cfg["phantom"]](
        tuple(cfg["volume"]), cfg["channels"], tumour_voxels, g, dev)


def cloud(cfg: dict, tumour_voxels: int, g, dev):
    """(1, N, 3) xyz (voxel coords / dims), (1, N, 3 + F) features
    cat(xyz, F noisy channels), (1, N) labels."""
    shape = tuple(cfg["volume"])
    n = cfg["pointseg"]["num_points"]
    classes = cfg["pointseg"]["num_classes"]
    xx, yy, zz = _axes(shape, dev)
    centre = [s * (0.5 + d) for s, d in
              zip(shape, _uniform(g, dev, -0.1, 0.1, 3))]
    radius = (3.0 * tumour_voxels / (4.0 * math.pi)) ** (1.0 / 3.0)
    d = torch.sqrt((xx - centre[0]) ** 2 + (yy - centre[1]) ** 2
                   + (zz - centre[2]) ** 2).reshape(-1)
    inside = torch.nonzero(d < radius).squeeze(1)[:n]
    rest = torch.nonzero(d >= radius).squeeze(1)
    rest = rest[torch.randperm(rest.numel(), generator=g, device=dev)]
    flat = torch.cat([inside, rest[:n - inside.numel()]])
    flat = flat[torch.randperm(flat.numel(), generator=g, device=dev)]
    dims = torch.tensor(shape, device=dev)
    coords = torch.stack([flat // (dims[1] * dims[2]),
                          (flat // dims[2]) % dims[1], flat % dims[2]], 1)
    xyz = coords.float() / dims.float()
    shells = torch.linspace(-radius, 0, classes, device=dev)[:-1]
    labels = torch.bucketize(-d[flat], shells) if classes > 2 else (
        d[flat] < radius).long()
    labels = labels.clamp(max=classes - 1)
    feats = torch.randn((n, cfg["pointseg"]["num_features"]), generator=g,
                        device=dev) + labels[:, None].float()
    return xyz[None], torch.cat([xyz, feats], 1)[None], labels[None]


def patches(cfg: dict, batch: int, blob_voxels, g, dev):
    """images (B, D, H, W, C) f32, weights (B, D, H, W) f32, labels (B, D,
    H, W) int64: noise, one labelled blob a patch."""
    shape = tuple(cfg["saliency"]["patch_size"])
    c = cfg["saliency"]["in_channels"]
    zz, yy, xx = _axes(shape, dev)
    labels = []
    for i in range(batch):
        centre = [s * (0.5 + d) for s, d in
                  zip(shape, _uniform(g, dev, -0.2, 0.2, 3))]
        labels.append(_ellipsoid(zz, yy, xx, centre,
                                 _radii(blob_voxels[i], g, dev)) < 1)
    labels = torch.stack(labels).long()
    images = torch.randn((batch,) + shape + (c,), generator=g, device=dev)
    images += 1.5 * labels[..., None]
    return images, torch.ones(labels.shape, device=dev), labels
