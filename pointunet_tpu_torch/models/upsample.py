"""Volumetric upsampling (``pointunet_tpu/models/upsample.py``).

``bilinear_upsample_3d`` is the closed form of the reference's functional
BilinearUpsampling3D: a stride-s transposed conv with a constant-ones
(s, s, s, C, C) filter, then a ones / s^3 smoothing conv. Both ones
filters sum over the channels, so every output channel holds the same
value: the nearest upsample of the channel sum, box-averaged over an
(s, s, s) SAME window and multiplied by C. Nothing in the model calls
it; it is part of the reference's layer surface. Channels first.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .fastconv import _nearest_upsample, same_padding


def bilinear_upsample_3d(x: torch.Tensor, scale: int) -> torch.Tensor:
    """(B, C, D, H, W) -> (B, C, D*s, H*s, W*s), the reference's values."""
    c, s = x.shape[1], scale
    y = _nearest_upsample(x.sum(dim=1, keepdim=True), s)   # (B, 1, sD, sH, sW)
    pads = same_padding(y.shape[2:], (s,) * 3, (1,) * 3, (1,) * 3)
    y = F.pad(y, [p for lo_hi in reversed(pads) for p in lo_hi])
    kernel = torch.full((1, 1, s, s, s), float(c) / s ** 3, dtype=y.dtype,
                        device=y.device)
    return F.conv3d(y, kernel).expand(-1, c, -1, -1, -1)
