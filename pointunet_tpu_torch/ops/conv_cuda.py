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
  CUDA tensors it launches one of the two kernels of ``csrc/conv3x3.cu``,
  as ``conv_path`` chooses, or raises. ``LAUNCHES`` counts its launches.
* ``conv_path(dtype, cin, cout, wd)``: ``"tensor_cores"`` for bf16 with
  Cin % 16 == 0 and an even W (every bf16 conv of the saliency net but
  the 4 -> 16 init conv), ``"cuda_cores"`` otherwise (f32, the init conv).
* ``pack_weight(w)``: the tensor-core path's B operand, (Cin / 16, 27,
  Cout rounded up to 8, 16), K-major, with ``wp[c // 16, dz * 9 + dy * 3
  + dx, o, c % 16] = w[o, c, dz, dy, dx]`` and zeros for o >= Cout. Plain
  torch, once a call: layout preparation (0.4 MB for 128 -> 64, 3.5 MB
  for 256 -> 256), not the conv.

What bounds it on the H100 is operations (2 x 27 x Cin x Cout a voxel,
far above the card's ratio of operations to bytes). The first port ran
every conv as f32 FMAs on the CUDA cores, 36x over its bf16 bound; bf16
now runs as an implicit GEMM on the tensor cores (wgmma m64nNk16 with A
from registers and B from shared memory, f32 sums in registers, a
3-stage cp.async ring, each stage transposed in shared memory so that
the dx = +-1 taps stay aligned for ldmatrix; the source note has the
design). f32 stays on the CUDA cores: TF32 would miss the f32 bar. An
optional bias is added after the rounding, in the input's type (the
reference's ``y + bias``); both kernels fuse that add in the same order.
The library is built and loaded by ``ops/cuda_build.py`` at first use.
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
TC_CHANNELS = 16         # input channels a tensor-core stage (one k16)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library, with both
    entry points typed (the same argument types: four pointers, seven
    ints, the stream)."""
    lib = cuda_build.load(SOURCE, "conv3x3_launch", _ARGTYPES)
    fn = lib.conv3x3_tc_launch
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return lib


def conv_path(dtype: torch.dtype, cin: int, cout: int, wd: int) -> str:
    """Which kernel takes a conv on the card: ``"tensor_cores"`` for bf16
    with Cin a multiple of 16 and an even W (any Cout: N is padded to 8),
    ``"cuda_cores"`` for the rest (f32; Cin = 4; odd W)."""
    if dtype == torch.bfloat16 and cin % TC_CHANNELS == 0 and wd % 2 == 0:
        return "tensor_cores"
    return "cuda_cores"


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> (Cin / 16, 27, Np, 16) in w's type, Np =
    Cout rounded up to 8: ``wp[c // 16, dz * 9 + dy * 3 + dx, o, c % 16] =
    w[o, c, dz, dy, dx]``, zeros for o >= Cout."""
    cout, cin = w.shape[:2]
    np_ = -(-cout // 8) * 8
    wp = torch.zeros((cin // TC_CHANNELS, 27, np_, TC_CHANNELS),
                     dtype=w.dtype, device=w.device)
    wp[:, :, :cout] = w.reshape(
        cout, cin // TC_CHANNELS, TC_CHANNELS, 27).permute(1, 3, 0, 2)
    return wp


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
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bias_ptr = None if bias is None else bias.data_ptr()
    with torch.cuda.device(dev):
        if conv_path(x.dtype, cin, cout, wd) == "tensor_cores":
            wp = pack_weight(w)
            rc = lib.conv3x3_tc_launch(
                x.data_ptr(), wp.data_ptr(), bias_ptr, out.data_ptr(),
                b, cin, cout, wp.shape[2], d, h, wd, stream,
            )
        else:
            rc = lib.conv3x3_launch(
                x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(),
                b, cin, cout, d, h, wd, _DTYPES[x.dtype], stream,
            )
    if rc != 0:
        raise RuntimeError(f"conv3d_3x3: kernel launch failed, CUDA error {rc}")
    LAUNCHES += 1
    return out
