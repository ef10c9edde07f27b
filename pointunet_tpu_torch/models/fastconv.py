"""3-D convolution with the reference's SAME padding (``pointunet_tpu/models/fastconv.py``).

``Conv`` is the port of ``FastConv`` (flax-named ``Conv``): a channels-first
``F.conv3d`` whose "SAME" padding follows XLA's rule, per axis

    out = ceil(in / stride);  extent = (k - 1) * dilation + 1
    total = max((out - 1) * stride + extent - in, 0)
    lo = total // 2;  hi = total - lo

For a stride-2 3x3x3 conv on an even input that is (0, 1), where torch's
``padding=1`` would pad (1, 1) and shift every output voxel. Symmetric
pads go to the convolution itself; asymmetric ones are applied with
``F.pad`` first.

With ``POINTUNET_FASTCONV=pallas`` in the environment (read at call time,
as the reference does), every stride-1, dilation-1 3x3x3 conv runs kernel
3 (``ops/conv_cuda.py:conv3d_3x3``) instead of ``F.conv3d``: the route of
the reference's Pallas conv, without its TPU backend test. The
reference's other modes (``all``, ``fold1``, ``k9``: its depth-batched
2-D decomposition) and its optimisation barrier are TPU workarounds and
are not ported; they, like any other value, leave the route off.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.conv_cuda import conv3d_3x3


def _triple(v) -> Tuple[int, int, int]:
    return (v,) * 3 if isinstance(v, int) else tuple(v)


def same_padding(size, kernel, stride, dilation):
    """Per-axis (lo, hi) SAME pads, XLA's rule."""
    pads = []
    for n, k, s, d in zip(size, kernel, stride, dilation):
        out = -(-n // s)
        total = max((out - 1) * s + (k - 1) * d + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _decomposition_mode() -> str:
    """``"pallas"`` when ``POINTUNET_FASTCONV`` asks for the fused 3x3x3
    conv route, else ``"off"``."""
    if os.environ.get("POINTUNET_FASTCONV", "") == "pallas":
        return "pallas"
    return "off"


def _nearest_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour repeat along D, H, W (keras UpSampling3D)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


class Conv(nn.Module):
    """SAME 3-D convolution of channels-first input, optionally on the
    nearest-upsampled input (``upsample > 1``). ``dtype`` None computes in
    the promoted type of input and weight, as flax does."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size,
        strides=1,
        kernel_dilation=1,
        upsample: int = 1,
        use_bias: bool = True,
        dtype: Optional[torch.dtype] = None,
    ):
        super().__init__()
        self.kernel_size = _triple(kernel_size)
        self.strides = _triple(strides)
        self.dilation = _triple(kernel_dilation)
        self.upsample = upsample
        self.dtype = dtype
        self.weight = nn.Parameter(
            torch.zeros((features, in_features) + self.kernel_size)
        )
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        x = x.to(dt)
        w = self.weight.to(dt)
        b = None if self.bias is None else self.bias.to(dt)
        if self.upsample > 1:
            x = _nearest_upsample(x, self.upsample)
        if (
            _decomposition_mode() == "pallas"
            and self.kernel_size == (3, 3, 3)
            and self.strides == (1, 1, 1)
            and self.dilation == (1, 1, 1)
        ):
            return conv3d_3x3(x.contiguous(), w.contiguous(), b)
        pads = same_padding(
            x.shape[2:], self.kernel_size, self.strides, self.dilation
        )
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        return F.conv3d(
            x, w, b, stride=self.strides, padding=padding,
            dilation=self.dilation,
        )
