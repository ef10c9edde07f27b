"""Spatial and channel-wise attention gates (``pointunet_tpu/models/attention3d.py``).

Channels-first: (B, C, D, H, W) for the 3-D gates the saliency net uses,
(B, C, H, W) for the 2-D ones, which complete the reference's layer set
(no model of either package calls them).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .fastconv import Conv
from .naming import FlaxNamed
from .norms import NormRelu


class SpatialAttention3D(FlaxNamed):
    """Three separable k=9 conv pairs summed -> sigmoid -> broadcast over C.

    broadcast=False returns the raw (B, 1, D, H, W) gate, which the strided
    gate mode resizes before the multiply."""

    def __init__(
        self,
        channels: int,
        instance_norm: bool = True,
        kernel: int = 9,
        dtype: Optional[torch.dtype] = None,
        broadcast: bool = True,
    ):
        super().__init__()
        k, c = kernel, channels
        self.channels = c
        self.broadcast = broadcast
        self.branches = []
        for pair_a, pair_b in (
            ((1, k, k), (k, 1, 1)),
            ((k, 1, k), (1, k, 1)),
            ((k, k, 1), (1, 1, k)),
        ):
            self.branches.append((
                self.child("Conv", Conv(c, c // 2, pair_a, dtype=dtype)),
                self.child("NormRelu", NormRelu(c // 2, instance_norm)),
                self.child("Conv", Conv(c // 2, 1, pair_b, dtype=dtype)),
                self.child("NormRelu", NormRelu(1, instance_norm)),
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = None
        for conv_a, norm_a, conv_b, norm_b in self.branches:
            h = norm_b(conv_b(norm_a(conv_a(x))))
            gate = h if gate is None else gate + h
        gate = torch.sigmoid(gate)                       # (B, 1, D, H, W)
        if not self.broadcast:
            return gate
        return gate.expand(-1, self.channels, -1, -1, -1)


class ChannelWiseAttention3D(FlaxNamed):
    """GAP -> dense(C/4, relu) -> dense(C, sigmoid) -> multiply, in the
    reference's types: the mean is summed in f32 and rounded to the
    input's type (``jnp.mean``), the dense layers run in at least f32, and
    the product is the promoted type (f32 for a bf16 input: the next
    conv rounds it once). The mean runs over every axis after C."""

    def __init__(self, channels: int):
        super().__init__()
        self.child("Dense", nn.Linear(channels, channels // 4), "fc1")
        self.child("Dense", nn.Linear(channels // 4, channels), "fc2")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        spatial = tuple(range(2, x.ndim))
        f32 = torch.promote_types(x.dtype, torch.float32)
        att = x.mean(dim=spatial, dtype=f32).to(x.dtype)       # (B, C)
        att = torch.sigmoid(self.fc2(F.relu(self.fc1(att.to(f32)))))
        return x * att[(...,) + (None,) * len(spatial)]


class SpatialAttention2D(FlaxNamed):
    """2-D gate: two separable k=9 branches (conv, norm+relu, conv,
    norm+relu) summed -> sigmoid -> broadcast over C. The convs are flax's
    2-D ``nn.Conv`` (SAME, stride 1, f32): here ``nn.Conv2d`` with odd
    kernels and symmetric pads, its weight (Cout, Cin, kh, kw)."""

    def __init__(self, channels: int, kernel: int = 9,
                 instance_norm: bool = True):
        super().__init__()
        k, c = kernel, channels
        self.channels = c
        self.branches = []
        for pair_a, pair_b in (((1, k), (k, 1)), ((k, 1), (1, k))):
            self.branches.append((
                self.child("Conv", nn.Conv2d(c, c // 2, pair_a,
                                             padding="same")),
                self.child("NormRelu", NormRelu(c // 2, instance_norm)),
                self.child("Conv", nn.Conv2d(c // 2, 1, pair_b,
                                             padding="same")),
                self.child("NormRelu", NormRelu(1, instance_norm)),
            ))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gate = None
        for conv_a, norm_a, conv_b, norm_b in self.branches:
            h = norm_b(conv_b(norm_a(conv_a(x))))
            gate = h if gate is None else gate + h
        return torch.sigmoid(gate).expand(-1, self.channels, -1, -1)


class ChannelWiseAttention2D(ChannelWiseAttention3D):
    """2-D channel gate of (B, C, H, W): the same layers, the mean over
    (H, W)."""
