"""SAME, stride-1 3x3x3 convolution: kernel 3 and its plain version
(``pointunet_tpu/ops/conv_pallas.py``).

Replaces ``conv_pallas.conv3d_3x3_pallas`` (and its batched entry), which
the reference routes every eligible conv of the saliency net through when
``POINTUNET_FASTCONV=pallas`` (``models/fastconv.py``). The function: each
output voxel is the sum of 27 shifted taps (Cin) @ (Cin, Cout), zeros
outside the volume, products and sums in f32, rounded once to the input's
type; the weight is cast to that type first. The port keeps its
channels-first layout: x (B, Cin, D, H, W), w (Cout, Cin, 3, 3, 3).

* ``conv3d_3x3_plain`` sums the 27 tap products in plain torch (f32) and
  casts once. It is the function the kernel computes, not ``F.conv3d``.
  The CPU path and the comparison on the card use it.
* ``conv3d_3x3`` is the wrapper: the plain version for CPU tensors; for
  CUDA tensors it launches the kernel of ``csrc/conv3x3.cu`` or raises.
  ``LAUNCHES`` counts its kernel launches.

An optional bias is added after the rounding, in the input's type (the
reference's ``y + bias``); the kernel fuses that add in the same order.
The kernel's source note says what bounds it on the H100 (operations: it
runs on the CUDA cores in f32) and how its design answers that. The
library is built and loaded by ``ops/cuda_build.py`` at first use.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from . import cuda_build

# kernel launches made by ``conv3d_3x3`` in this process
LAUNCHES = 0

SOURCE = cuda_build.CSRC / "conv3x3.cu"
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return cuda_build.load(SOURCE, "conv3x3_launch", _ARGTYPES)


def conv3d_3x3_plain(
    x: torch.Tensor,                 # (B, Cin, D, H, W)
    w: torch.Tensor,                 # (Cout, Cin, 3, 3, 3)
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's function in plain torch: (B, Cout, D, H, W) in x's
    type, the 27 tap products summed in f32."""
    b, _, d, h, wd = x.shape
    xp = F.pad(x.float(), (1, 1, 1, 1, 1, 1))
    wf = w.float()
    acc = torch.zeros((b, w.shape[0], d, h, wd), dtype=torch.float32,
                      device=x.device)
    for dz in range(3):
        for dy in range(3):
            for dx in range(3):
                acc += torch.einsum(
                    "bcdhw,oc->bodhw",
                    xp[:, :, dz:dz + d, dy:dy + h, dx:dx + wd],
                    wf[:, :, dz, dy, dx],
                )
    y = acc.to(x.dtype)
    if bias is not None:
        y = y + bias.to(x.dtype).view(1, -1, 1, 1, 1)
    return y


def conv3d_3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SAME, stride-1 3x3x3 conv (see the module docstring); x, w and
    bias of one type, f32 or bf16.

    CPU tensors take the plain version. CUDA tensors launch the kernel;
    anything the kernel does not take raises."""
    global LAUNCHES
    tensors = (x, w) if bias is None else (x, w, bias)
    if x.dtype not in _DTYPES or any(t.dtype != x.dtype for t in tensors):
        raise ValueError(
            "conv3d_3x3: x, w and bias must all be float32 or all bfloat16, "
            f"got {[t.dtype for t in tensors]}"
        )
    if (x.ndim != 5 or w.ndim != 5 or tuple(w.shape[1:]) != (x.shape[1], 3, 3, 3)
            or (bias is not None and tuple(bias.shape) != (w.shape[0],))):
        raise ValueError(
            "conv3d_3x3: x must be (B, Cin, D, H, W), w (Cout, Cin, 3, 3, 3) "
            f"and bias (Cout,), got {tuple(x.shape)}, {tuple(w.shape)}, "
            f"{None if bias is None else tuple(bias.shape)}"
        )
    if all(t.device.type == "cpu" for t in tensors):
        return conv3d_3x3_plain(x, w, bias)
    dev = x.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "conv3d_3x3: inputs must all be on the CPU or all on one CUDA "
            f"device, got {[str(t.device) for t in tensors]}"
        )
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("conv3d_3x3: x, w and bias must be contiguous")
    b, cin, d, h, wd = x.shape
    cout = w.shape[0]
    if b * d > 65535 or min(x.shape) < 1:
        raise ValueError(
            f"conv3d_3x3: B * D must be in [1, 65535], got {tuple(x.shape)}"
        )
    out = torch.empty((b, cout, d, h, wd), dtype=x.dtype, device=dev)
    fn = load_library().conv3x3_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(
            x.data_ptr(), w.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(),
            b, cin, cout, d, h, wd, _DTYPES[x.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"conv3d_3x3: kernel launch failed, CUDA error {rc}")
    LAUNCHES += 1
    return out
