"""Sliding-window (overlapping-tile) volumetric inference
(``pointunet_tpu/ops/window.py``).

The reference runs the tiling as one ``lax.scan`` over the static window
starts; here it is a Python loop over the same starts. Numerics match the
reference: windows that reach past the volume see zero padding, the
per-window probabilities are summed in f32 and divided by the per-voxel
cover count (at least 1), and only the valid region is returned. The
layout is the port's: channels first.
"""
from __future__ import annotations

import itertools
from typing import Callable, Sequence

import numpy as np
import torch


def window_positions(size: int, patch: int, step: int) -> np.ndarray:
    """Start offsets along one axis (the reference's eval.py rule)."""
    return np.arange(0, max(1, size - patch + step), step)


def sliding_window_inference(
    volume: torch.Tensor,                  # (C_in, D, H, W)
    model_fn: Callable[[torch.Tensor], torch.Tensor],
    patch: Sequence[int],
    steps: Sequence[int],
    num_classes: int,
) -> torch.Tensor:
    """Averaged per-voxel class scores (num_classes, D, H, W) f32.
    ``model_fn`` maps a (1, C_in, pd, ph, pw) window to (1, num_classes,
    pd, ph, pw)."""
    c_in, d, h, w = volume.shape
    pd, ph, pw = patch
    pos = [
        window_positions(s, p, st)
        for s, p, st in zip((d, h, w), patch, steps)
    ]
    padded_shape = tuple(int(p.max()) + n for p, n in zip(pos, patch))
    padded = volume.new_zeros((c_in,) + padded_shape)
    padded[:, :d, :h, :w] = volume
    acc = torch.zeros((num_classes,) + padded_shape, dtype=torch.float32,
                      device=volume.device)
    count = torch.zeros(padded_shape, dtype=torch.float32,
                        device=volume.device)
    for z, y, x in itertools.product(*(p.tolist() for p in pos)):
        window = padded[:, z:z + pd, y:y + ph, x:x + pw]
        pred = model_fn(window[None])[0].float()
        acc[:, z:z + pd, y:y + ph, x:x + pw] += pred
        count[z:z + pd, y:y + ph, x:x + pw] += 1.0
    out = acc / count.clamp(min=1.0)
    return out[:, :d, :h, :w]
