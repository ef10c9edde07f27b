"""Seeded weights, made on the device in one draw.

Every parameter of a module is filled from one uniform draw of a
``torch.Generator`` on the module's device: dense and conv weights
glorot-uniform (limit sqrt(6 / (fan_in + fan_out))), biases uniform in
+-0.1, norm scales 1 +- 0.1. The result is a flat dict of the tensors by
state-dict name, which the plain reference reads as it is.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

MASK = (1 << 63) - 1


def sub_seed(seed: int, *path: int) -> int:
    """A 63-bit seed for one use of a run's seed (``path`` names the use)."""
    h = seed & MASK
    for p in path:
        h = (h * 6364136223846793005 + 1442695040888963407 + p) & MASK
    return h


@torch.no_grad()
def fill(model: nn.Module, seed: int) -> Dict[str, torch.Tensor]:
    """Fill ``model``'s parameters in place; its state dict (parameters and
    buffers) by name."""
    params = list(model.named_parameters())
    dev = params[0][1].device
    total = sum(p.numel() for _, p in params)
    g = torch.Generator(device=dev).manual_seed(seed & MASK)
    u = torch.rand(total, generator=g, device=dev).mul_(2).sub_(1)
    off = 0
    for name, p in params:
        chunk = u[off:off + p.numel()].view_as(p)
        off += p.numel()
        if p.ndim >= 2:
            rf = math.prod(p.shape[2:])
            limit = math.sqrt(6.0 / ((p.shape[0] + p.shape[1]) * rf))
            p.copy_(chunk * limit)
        elif name.endswith("bias"):
            p.copy_(chunk * 0.1)
        else:
            p.copy_(chunk * 0.1 + 1.0)
    return {k: v.detach() for k, v in model.state_dict().items()}
