"""3-D convolution with the reference's SAME padding and its conv routes
(``pointunet_tpu/models/fastconv.py``).

``Conv`` is the port of ``FastConv`` (flax-named ``Conv``): a channels-first
3-D conv whose "SAME" padding follows XLA's rule, per axis

    out = ceil(in / stride);  extent = (k - 1) * dilation + 1
    total = max((out - 1) * stride + extent - in, 0)
    lo = total // 2;  hi = total - lo

For a stride-2 3x3x3 conv on an even input that is (0, 1), where torch's
``padding=1`` would pad (1, 1) and shift every output voxel. Symmetric
pads go to the convolution itself; asymmetric ones are applied with
``F.pad`` first.

Routes, taken in the reference's order and read from the environment at
call time, as the reference reads them:

1. ``upsample > 1`` with ``POINTUNET_FUSED_UPSAMPLE=1`` and a stride-1,
   dilation-1 3x3x3 kernel: ``fused_upsample_conv3d``, the conv of the
   nearest-upsampled input computed exactly at the coarse resolution;
   else the input is nearest-upsampled first;
2. ``POINTUNET_FASTCONV`` (``_decomposition_mode``): ``pallas`` sends
   every stride-1, dilation-1 3x3x3 conv to kernel 3
   (``ops/conv_cuda.py:conv3d_3x3``; the reference's Pallas conv, without
   its TPU backend test);
3. else, in every mode but ``off``, a stride-1, dilation-1 conv with a
   kernel axis of size 1 or 3 (``_decomposable``) is folded into 2-D
   convs over a batch of slices (``fast_conv3d``): ``all`` (or ``1``)
   folds every such conv, ``fold1`` only kernels with a size-1 axis,
   ``k9`` only kernels of at least 9 taps along some axis (the six
   separable gate convs), ``pallas`` the convs that are not 3x3x3 (the
   gate's and the 1x1x1 convs);
4. else ``F.conv3d``.

Unset, ``off``, ``0`` or any other value leaves routes 2 and 3 off on
every device: every conv is ``F.conv3d`` (the reference's rule off the
TPU). Strided and dilated convs take ``F.conv3d`` in every mode.

The fold and the coarse upsample conv are no TPU kernels: the reference
computes them with XLA convs outside any Pallas kernel, and ``F.conv2d``
and ``F.conv3d`` are their counterparts here. The folded 2-D convs run
channels-last (NHWC memory), the layout in which cuDNN's bf16 convs
reach the tensor cores: the input is permuted once into (B * S_fold,
S_1, S_2, Cin) and the sum back into channels-first once. The
reference's optimisation barrier has no meaning in eager PyTorch.
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
    """The conv route ``POINTUNET_FASTCONV`` asks for: ``"all"`` (``all``
    or ``1``), ``"fold1"``, ``"k9"``, ``"pallas"``, else ``"off"``."""
    force = os.environ.get("POINTUNET_FASTCONV", "")
    if force in ("all", "1"):
        return "all"
    if force in ("fold1", "k9", "pallas"):
        return force
    return "off"


def _decomposable(kernel: Tuple[int, int, int]) -> Optional[int]:
    """The kernel axis to fold into the batch, or None: a size-1 axis
    first (one 2-D conv, no shifts), else a size-3 axis (three)."""
    for size in (1, 3):
        for ax in range(3):
            if kernel[ax] == size:
                return ax
    return None


def _fused_upsample_enabled() -> bool:
    """``POINTUNET_FUSED_UPSAMPLE=1`` opts in to ``fused_upsample_conv3d``."""
    return os.environ.get("POINTUNET_FUSED_UPSAMPLE", "0") == "1"


def fused_upsample_conv3d(
    x: torch.Tensor,       # (B, Cin, D, H, W) coarse input
    w: torch.Tensor,       # (Cout, Cin, 3, 3, 3) full-resolution kernel
    scale: int,
) -> torch.Tensor:
    """Exactly SAME ``conv3d(nearest_upsample(x, scale), w)``, computed at
    the coarse resolution: (B, Cout, D * s, H * s, W * s).

    With the output index o = s * j + q, phases q in [1, s], every
    full-resolution tap o + d (d in {-1, 0, 1}) reads coarse row j +
    floor((q + d) / s), which is j or j + 1: each phase is a 2-tap
    coarse conv whose taps sum the kernel's taps (the tap matrix ``T``).
    One VALID 2x2x2 conv of the input padded by 1 emits the s^3 phases as
    channels, in (q, r, p, o) order as in the reference; depth-to-space
    and a crop at offset s - 1 give the result. The re-bucketed weight is
    summed in f32 and rounded once to ``w``'s type."""
    if tuple(w.shape[2:]) != (3, 3, 3):
        raise ValueError(f"fused_upsample_conv3d takes a 3x3x3 kernel, got "
                         f"{tuple(w.shape)}")
    s = scale
    cout, cin = w.shape[:2]
    q = torch.arange(1, s + 1)[:, None, None]
    t = torch.arange(2)[None, :, None]
    k = torch.arange(3)[None, None, :]
    tap = ((q + k - 1) // s == t).float().to(w.device)        # (s, 2, 3)
    w2 = torch.einsum("qak,rbl,pcm,oiklm->qrpoiabc", tap, tap, tap, w.float())
    w2 = w2.reshape(s ** 3 * cout, cin, 2, 2, 2).to(w.dtype)
    y = F.conv3d(F.pad(x, (1, 1, 1, 1, 1, 1)), w2)  # (B, s^3 Cout, D+1, ..)
    b, _, d1, h1, w1 = y.shape
    y = y.view(b, s, s, s, cout, d1, h1, w1).permute(0, 4, 5, 1, 6, 2, 7, 3)
    y = y.reshape(b, cout, d1 * s, h1 * s, w1 * s)
    d, h, wd = x.shape[2:]
    return y[:, :, s - 1:s - 1 + d * s, s - 1:s - 1 + h * s,
             s - 1:s - 1 + wd * s]


def fast_conv3d(
    x: torch.Tensor,       # (B, Cin, S0, S1, S2)
    w: torch.Tensor,       # (Cout, Cin, k0, k1, k2)
    fold_axis: int,
) -> torch.Tensor:
    """SAME, stride-1, dilation-1 3-D conv as 2-D convs over the slices
    of spatial axis ``fold_axis``, folded into the batch (channels-last):
    ``out[d] = sum_i conv2d(x[d + i - kd // 2], w[i])``, each shifted term
    zero-filled at the edge and summed in slice order in the compute
    type, as the reference sums them. Returns (B, Cout, S0, S1, S2),
    contiguous."""
    a = fold_axis
    rest = [i for i in range(3) if i != a]
    b, cin = x.shape[:2]
    cout = w.shape[0]
    d, h, wd = (x.shape[2 + i] for i in [a] + rest)
    kd = w.shape[2 + a]
    xb = x.permute(0, 2 + a, 2 + rest[0], 2 + rest[1], 1)
    xb = xb.reshape(b * d, h, wd, cin).permute(0, 3, 1, 2)   # NHWC memory
    wt = w.permute(2 + a, 0, 1, 2 + rest[0], 2 + rest[1])   # (kd, O, I, kh, kw)
    pad = kd // 2
    out = None
    for i in range(kd):
        wi = wt[i].contiguous(memory_format=torch.channels_last)
        # torch's "same" pads as XLA's SAME at stride 1 (the odd extra
        # after)
        y = F.conv2d(xb, wi, padding="same")                # (B d, O, h, wd)
        y = y.permute(0, 2, 3, 1).reshape(b, d, h, wd, cout)
        off = i - pad                                       # out[d] += y[d + off]
        if off:
            shifted = torch.zeros_like(y)
            if off > 0:
                shifted[:, :max(d - off, 0)] = y[:, off:]
            else:
                shifted[:, -off:] = y[:, :max(d + off, 0)]
            y = shifted
        out = y if out is None else out + y
    inv = [0, 0, 0]
    for pos, ax in enumerate([a] + rest):
        inv[ax] = pos + 1
    return out.permute(0, 4, *inv).contiguous()


def _nearest_upsample(x: torch.Tensor, scale: int) -> torch.Tensor:
    """Nearest-neighbour repeat along D, H, W (keras UpSampling3D)."""
    return F.interpolate(x, scale_factor=scale, mode="nearest")


class Conv(nn.Module):
    """SAME 3-D convolution of channels-first input, optionally on the
    nearest-upsampled input (``upsample > 1``), on the route the
    environment asks for (see the module docstring). ``dtype`` None
    computes in the promoted type of input and weight, as flax does."""

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
        unit = self.strides == (1, 1, 1) and self.dilation == (1, 1, 1)
        k333 = self.kernel_size == (3, 3, 3)
        if self.upsample > 1:
            if k333 and unit and _fused_upsample_enabled():
                return _add_bias(fused_upsample_conv3d(x, w, self.upsample), b)
            x = _nearest_upsample(x, self.upsample)
        mode = _decomposition_mode()
        if mode == "pallas" and k333 and unit:
            return conv3d_3x3(x.contiguous(), w.contiguous(), b)
        fold = _decomposable(self.kernel_size)
        if mode == "fold1" and fold is not None and self.kernel_size[fold] != 1:
            fold = None
        if mode == "k9" and max(self.kernel_size) < 9:
            fold = None
        if unit and fold is not None and mode != "off":
            return _add_bias(fast_conv3d(x, w, fold), b)
        pads = same_padding(
            x.shape[2:], self.kernel_size, self.strides, self.dilation
        )
        if all(lo == hi for lo, hi in pads):
            padding = tuple(lo for lo, _ in pads)
        else:
            x = F.pad(x, [p for lo_hi in reversed(pads) for p in lo_hi])
            padding = 0
        # the bias added after the conv's rounding, as the reference adds it
        # (CPU convs would fuse it into their f32 sums)
        return _add_bias(F.conv3d(
            x, w, stride=self.strides, padding=padding,
            dilation=self.dilation,
        ), b)


# the reference's class name (flax names the module ``Conv``, whence the
# port's class name and its parameters' names)
FastConv = Conv


def _add_bias(y: torch.Tensor, b: Optional[torch.Tensor]) -> torch.Tensor:
    """``y + b`` over the channel axis, in y's type (the reference adds its
    bias after the conv)."""
    return y if b is None else y + b.view(1, -1, 1, 1, 1)
