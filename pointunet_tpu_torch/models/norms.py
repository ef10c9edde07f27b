"""Normalisation layers (``pointunet_tpu/models/norms.py``), plus the
last-axis inference ``BatchNorm`` of the point net.

Volumes are channels-first (B, C, D, H, W). Instance norm is GroupNorm
with one channel per group, eps 1e-5; on bf16 inputs PyTorch reduces the
statistics in f32. The reference computes the variance as E[x^2] - E[x]^2
and PyTorch in two passes: in f32 the two differ by rounding only
(tests/test_torch_saliency.py states the tolerance).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .naming import FlaxNamed


class BatchNorm(nn.Module):
    """Batch norm over the LAST axis in flax's arithmetic
    (``flax.linen.BatchNorm``): (x - mean) * (rsqrt(var + eps) * scale) +
    bias. State names follow torch (weight, bias, running_mean,
    running_var).

    Eval mode normalises with the running statistics. Train mode takes
    the batch's: mean and ``var = max(0, E[x^2] - E[x]^2)`` (biased) over
    every axis but the last, in f32, normalises in f32 and returns the
    input's dtype; then ``running = m * running + (1 - m) * batch`` with
    ``m = momentum`` (flax's convention: 0.99 keeps 99 % of the old
    value, the opposite of ``nn.BatchNorm1d``'s)."""

    def __init__(self, features: int, eps: float, momentum: float):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        dt = x.dtype
        return (x - self.running_mean.to(dt)) * mul.to(dt) + self.bias.to(dt)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        dims = tuple(range(x.ndim - 1))
        mean = x32.mean(dims)
        var = torch.clamp(
            (x32 * x32).mean(dims) - mean * mean, min=0.0
        )
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(m).add_((1 - m) * mean)
            self.running_var.mul_(m).add_((1 - m) * var)
        y = (x32 - mean) * (torch.rsqrt(var + self.eps) * self.weight)
        return (y + self.bias).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """Instance norm over (D, H, W) of channels-first input; the affine
    parameters are applied in the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight.to(x.dtype), self.bias.to(x.dtype)
        if x[0, 0].numel() == 1:
            # one value per channel normalises to 0 (the reference gives
            # the bias; F.group_norm refuses such an input)
            return b[None, :, None, None, None].expand_as(x)
        return F.group_norm(x, self.num_groups, w, b, self.eps)


class NormRelu(FlaxNamed):
    """Instance norm (GroupNorm, group size 1) + relu. The reference's
    batch-norm flavour (``instance_norm=False``) is not ported: no config
    selects it."""

    def __init__(self, channels: int, instance_norm: bool = True):
        super().__init__()
        if not instance_norm:
            raise NotImplementedError("the batch-norm NormRelu is not ported")
        self.child("GroupNorm", GroupNorm(channels, channels, eps=1e-5), "norm")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(x))
