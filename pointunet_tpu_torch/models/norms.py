"""Normalisation layers (``pointunet_tpu/models/norms.py``), plus the
``BatchNorm`` of the point net.

Volumes are channels-first (B, C, D, H, W). Instance norm is GroupNorm
with one channel per group, eps 1e-5. The reference computes the
variance as E[x^2] - E[x]^2 and PyTorch's f32 ``group_norm`` in two
passes: in f32 the two differ by rounding only
(tests/test_torch_saliency.py states the tolerance). The batch-norm
flavour is ``BatchNorm`` on the channel axis 1.

On bf16 inputs both norms do what flax's ``_normalize`` does at
``dtype=bf16``: statistics, scale and bias stay f32, ``(x - mean) *
(rsqrt(var + eps) * scale) + bias`` is computed in f32 and rounded to
bf16 once (tests/test_torch_bf16_rounding.py holds each against flax in
bf16 ulps).
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.collectives import all_reduce_sum
from .naming import FlaxNamed


class _Frozen(threading.local):
    on = False


_frozen = _Frozen()


@contextlib.contextmanager
def running_stats_frozen():
    """Within (on this thread), train-mode ``BatchNorm``s normalise by the
    batch's statistics and leave their running ones as they are: a
    checkpointed block's recomputation in the backward must not update
    them a second time (flax's remat recomputes a pure function)."""
    prev, _frozen.on = _frozen.on, True
    try:
        yield
    finally:
        _frozen.on = prev


class BatchNorm(nn.Module):
    """Batch norm over the feature axis ``axis``, -1 (the last, as in the
    point net) or 1 (channels-first volumes), in flax's arithmetic
    (``flax.linen.BatchNorm``): (x - mean) * (rsqrt(var + eps) * scale) +
    bias. State names follow torch (weight, bias, running_mean,
    running_var).

    Eval mode normalises with the running statistics. Train mode takes
    the batch's: mean and ``var = max(0, E[x^2] - E[x]^2)`` (biased) over
    every other axis, in f32, normalises in f32 and returns the input's
    dtype; then ``running = m * running + (1 - m) * batch`` with ``m =
    momentum`` (flax's convention: 0.99 keeps 99 % of the old value, the
    opposite of ``nn.BatchNorm3d``'s, whose running variance is also the
    unbiased one).

    With a process ``group`` (the ranks that hold the other rows of one
    batch: a mesh's data group, or the whole mesh when its point axis
    splits each cloud's rows too), the train-mode statistics are those
    of the global batch, as GSPMD gives the reference: each rank's f32
    sums of x and x^2 and its count go through one autograd-aware sum
    over the group (``parallel.collectives.all_reduce_sum``), so every
    rank normalises by, and keeps, the same statistics."""

    def __init__(self, features: int, eps: float, momentum: float,
                 axis: int = -1, group=None):
        super().__init__()
        self.eps = eps
        self.momentum = momentum
        self.axis = axis
        self.group = group
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def _bcast(self, v: torch.Tensor, ndim: int) -> torch.Tensor:
        """A per-feature vector shaped to broadcast against an input of
        ``ndim`` axes (as it is for the last axis)."""
        if self.axis == -1:
            return v
        return v.view((-1,) + (1,) * (ndim - 2))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self._train_forward(x)
        mul = torch.rsqrt(self.running_var + self.eps) * self.weight
        shift = self.bias - self.running_mean * mul
        n = x.ndim
        # one multiply-add in at least f32, rounded once to x's type
        # (flax's order, (x - mean) * mul + bias, differs by f32 rounding)
        return torch.addcmul(self._bcast(shift, n), x,
                             self._bcast(mul, n)).to(x.dtype)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        n = x.ndim
        dims = tuple(d for d in range(n) if d != self.axis % n)
        if self.group is None:
            mean = x32.mean(dims)
            var = torch.clamp(
                (x32 * x32).mean(dims) - mean * mean, min=0.0
            )
        else:
            mean, var = self._global_moments(x32, dims)
        if not _frozen.on:
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(m).add_((1 - m) * mean)
                self.running_var.mul_(m).add_((1 - m) * var)
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (x32 - self._bcast(mean, n)) * self._bcast(mul, n)
        return (y + self._bcast(self.bias, n)).to(x.dtype)

    def _global_moments(self, x32: torch.Tensor, dims):
        """(mean, biased var) over ``dims`` of the rows of every rank of
        ``self.group``. The count travels in f32 beside the sums: exact
        up to 2^24 rows a reduction."""
        c = x32.shape[self.axis]
        count = x32.new_full((1,), x32.numel() // c)
        tot = all_reduce_sum(
            torch.cat([x32.sum(dims), (x32 * x32).sum(dims), count]),
            self.group,
        )
        mean = tot[:c] / tot[-1]
        var = torch.clamp(tot[c:2 * c] / tot[-1] - mean * mean, min=0.0)
        return mean, var


class GroupNorm(nn.GroupNorm):
    """Instance norm over (D, H, W) of channels-first input (one channel
    a group). bf16 inputs go through ``_InstanceNormOnce`` (CUDA's
    ``group_norm`` takes no f32 scale and bias on a bf16 input); f32 and
    f64 ones through ``F.group_norm``, whose two-pass variance and fused
    backward beat that function run in f32 at the bf16 train step's
    shapes (``probe_bf16_norms.py --train``: faster, 8 against 12 bytes
    a voxel above the input, input gradient 6.7e-8 against 9.6e-8 from
    f64)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.weight, self.bias
        if x[0, 0].numel() == 1:
            # one value per channel normalises to 0 (the reference gives
            # the bias; F.group_norm refuses such an input)
            return b.to(x.dtype)[None, :, None, None, None].expand_as(x)
        if x.dtype == torch.bfloat16:
            return _InstanceNormOnce.apply(x, w, b, self.eps)
        return F.group_norm(x, self.num_groups, w.to(x.dtype),
                            b.to(x.dtype), self.eps)


class _InstanceNormOnce(torch.autograd.Function):
    """Instance norm of a bf16 (B, C, ...) input with f32 ``w`` and ``b``
    in flax's arithmetic, rounded once. Forward: the f32 mean and E[x^2] -
    mean^2 from two reductions that read ``x`` as it is (a sum and
    ``vector_norm``, no f32 copy), then one f32 multiply-add of ``x``
    (``x * s + (b - mean * s)``, s = rsqrt(var + eps) * w; flax's order
    differs by f32 rounding only) written in x's type. 2.2x faster than
    ``F.group_norm`` at the Serve contract's shapes
    (``probe_bf16_norms.py``). Backward: from the saved f32 mean and
    rsqrt, the f32 sums of g and g * x a channel, and
    ``dx = a g + k1 x + k0`` with per-channel f32 a, k1, k0, written in
    x's type (rounded once); autograd through the forward's ops would
    keep several full-size f32 gradients and round dx three times."""

    @staticmethod
    def forward(ctx, x, w, b, eps):
        dims = tuple(range(2, x.ndim))
        n = x[0, 0].numel()
        shape = x.shape[:2] + (1,) * len(dims)
        mean = x.sum(dims, dtype=torch.float32) / n
        sq = torch.linalg.vector_norm(x, 2, dims, dtype=torch.float32)
        rstd = torch.rsqrt((sq.square() / n - mean * mean).clamp_min(0.0)
                           + eps)
        scale = rstd * w
        ctx.save_for_backward(x, w, mean, rstd)
        return torch.addcmul((b - mean * scale).view(shape), x,
                             scale.view(shape), out=torch.empty_like(x))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, w, mean, rstd = ctx.saved_tensors
        dims = tuple(range(2, x.ndim))
        n = x[0, 0].numel()
        shape = x.shape[:2] + (1,) * len(dims)
        s1 = g.sum(dims, dtype=torch.float32)                  # (B, C)
        # f32 products of the bf16 g and x, summed in f32
        gx = torch.addcmul(mean.new_zeros(shape), g, x).sum(dims)
        t = rstd * (gx - mean * s1)            # sum g * (x - mean) * rstd
        a = rstd * w
        k1 = -a * rstd * t / n
        dx = torch.addcmul((-a * s1 / n - k1 * mean).view(shape), x,
                           k1.view(shape))
        dx = torch.addcmul(dx, g, a.view(shape), out=torch.empty_like(x))
        return dx, t.sum(0), s1.sum(0), None


class NormRelu(FlaxNamed):
    """Norm + relu: instance norm (GroupNorm, group size 1) or, with
    ``instance_norm=False``, flax's ``BatchNorm`` over the channels
    (momentum 0.9, eps 1e-5; batch statistics in train mode, the running
    ones in eval mode). The reference's ``axis_name``, which would sync
    the batch statistics across a device mesh, is set by none of its
    callers (its ``SaliencyTrainer`` stores a mesh and never reads it),
    so the port takes none."""

    def __init__(self, channels: int, instance_norm: bool = True):
        super().__init__()
        if instance_norm:
            self.child("GroupNorm", GroupNorm(channels, channels, eps=1e-5),
                       "norm")
        else:
            self.child("BatchNorm", BatchNorm(channels, 1e-5, 0.9, axis=1),
                       "norm")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.norm(x))
