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
  CUDA tensors it launches one of the six designs of ``csrc/conv3x3.cu``,
  as ``conv_path`` chooses, or raises. ``LAUNCHES`` counts its calls
  that launch (one a call, whatever the number of grids).
  The kernel has no backward, as the reference's Pallas conv has none
  (JAX gives ``pallas_call`` a JVP rule but no transpose rule, so
  ``jax.grad`` through it raises): on CUDA tensors the wrapper raises
  (``refuse_autograd``) when autograd would need the conv's gradient,
  instead of returning an output with no ``grad_fn``. The CPU path stays
  the plain, differentiable version.
* ``conv_path(dtype, cin, cout, wd)``, for an even W: bf16 with Cin % 16
  == 0 takes ``"narrow_tensor_cores"`` for Cout <= 2 (the head; Cin <=
  256, W % 8 == 0, x 16-byte aligned), ``"deep_tensor_cores"`` for Cout >
  8 and W <= 64 that the wide design's
  32-column tiles do not cover exactly (the coarse levels but the
  Pancreas CT's W = 64 and 32, where those tiles are full and the wide
  design measured faster), else ``"tensor_cores"``; f32 takes
  ``"narrow_cuda_cores"`` for Cout <= 8 with Cin % 4 == 0 (its weight
  fitting shared memory), else ``"tensor_cores_3xtf32"`` with Cin % 8 ==
  0; the rest (the init conv, odd W) ``"cuda_cores"``.
* ``deep_tile`` and ``tc_splits``: the deep design's plan (rows a block,
  runs of Cin), passed to its launch; ``narrow_slabs``: the plain form of
  the narrow designs' slab rule (planes a block), which their kernels
  apply themselves.
* ``pack_weight(w)``: the bf16 tensor-core path's B operand, (Cin / 16,
  27, Cout rounded up to 8, 16), K-major, with ``wp[c // 16, dz * 9 + dy
  * 3 + dx, o, c % 16] = w[o, c, dz, dy, dx]`` and zeros for o >= Cout.
  Plain torch, once a call: layout preparation (0.4 MB for 128 -> 64,
  3.5 MB for 256 -> 256), not the conv.
* ``pack_weight_xf(w)`` and ``split_tf32(x)``: the plain forms of the
  3xTF32 kernel's own weight packing (a small kernel of the same launch
  writes it, split, into scratch that the wrapper allocates: one
  contiguous block of core matrices a stage, so that one thread stages
  it by a bulk copy) and of its operand split (f32 -> (hi, lo) as
  ``cvt.rna.tf32.f32`` rounds, by int32 bit operations; the kernel splits
  the weights when it packs them and the activations in registers).
* ``conv_splits(...)``: how many runs of input channels the 3xTF32 kernel
  splits a deep conv into (summed in a fixed order by a second kernel).

What bounds it on the H100 is operations for the wide convs (2 x 27 x
Cin x Cout a voxel, far above the card's ratio of operations to bytes)
and bytes for the head (Cout = 2). The first port ran every conv as f32
FMAs on the CUDA cores, 36x over its bf16 bound; the wide convs of both
types now run as implicit GEMMs on the tensor cores (wgmma with A from
registers and B from shared memory, f32 sums in registers, a 3-stage
cp.async ring; the source note has the designs). bf16 stages 16 channels
and transposes each stage for ldmatrix; f32 stages 8 and computes each
product as three TF32 products of split operands (3xTF32: hi x hi, hi x
lo, lo x hi): one TF32 product keeps 11 significant bits and misses the
2e-5 f32 bar. f32's least time is then 3 x operations over the card's
495 TFLOP/s of dense TF32, below the CUDA cores' 67 TFLOP/s of f32. The
head's designs read each input byte about once a block, the whole
weight resident: the bf16 one puts the 27 taps x 2 output channels in
the wgmma's N and sums the shifted partials per output voxel; the f32
one marches down a slab of planes on the CUDA cores, each staged plane
feeding the three output planes that read it. The deep design takes a
whole row width a block so that its M tile is filled, N = Cout up to
128, and
splits Cin into runs where its tiles cannot fill the card. An optional
bias is added after the rounding, in the input's type (the reference's
``y + bias``); every design fuses that add in the same order. The
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
_XF_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
_NW_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
_NF_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DP_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TC_CHANNELS = 16         # input channels a bf16 tensor-core stage (one k16)
XF_CHANNELS = 8          # input channels a 3xTF32 stage (one k8)
SPLIT_BLOCKS = 264       # blocks (2 an SM) below which 3xTF32 splits Cin
SMS = 132                # the H100's streaming multiprocessors
SMEM_BYTES = 232_448     # shared memory a block can take
NARROW_COUT = 8          # the f32 narrow design's widest Cout
NARROW_TC_COUT = 2       # the bf16 one's: 27 taps x 2 fill its N = 56
NARROW_TC_CIN = 256      # the bf16 narrow design's deepest Cin (resident)
NF_CHANNELS = 4          # input channels an f32 narrow stage
NF_RAW_BYTES = 3 * 4 * NF_CHANNELS * 42 * 40   # its ring: 3 x (4, 42, 40)
DEEP_MAX_W = 64          # the deep design's widest W (a whole row a block)


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library, with its
    six entry points typed."""
    lib = cuda_build.load(SOURCE, "conv3x3_launch", _ARGTYPES)
    for name, types in (("conv3x3_tc_launch", _ARGTYPES),
                        ("conv3x3_xf_launch", _XF_ARGTYPES),
                        ("conv3x3_nw_launch", _NW_ARGTYPES),
                        ("conv3x3_nf_launch", _NF_ARGTYPES),
                        ("conv3x3_dp_launch", _DP_ARGTYPES)):
        fn = getattr(lib, name)
        fn.argtypes = types
        fn.restype = ctypes.c_int
    return lib


def _narrow_co(cout: int) -> int:
    """Cout padded to the f32 narrow design's register tile: 2, 4 or 8."""
    return next(n for n in (2, 4, 8) if cout <= n)


def conv_path(dtype: torch.dtype, cin: int, cout: int, wd: int) -> str:
    """Which design takes a conv on the card (see the module docstring):
    ``"narrow_tensor_cores"``, ``"deep_tensor_cores"`` or
    ``"tensor_cores"`` for bf16, ``"narrow_cuda_cores"`` or
    ``"tensor_cores_3xtf32"`` for f32, ``"cuda_cores"`` for the rest."""
    if wd % 2 == 0 and dtype == torch.bfloat16 and cin % TC_CHANNELS == 0:
        if cout <= NARROW_TC_COUT and cin <= NARROW_TC_CIN and wd % 8 == 0:
            return "narrow_tensor_cores"
        if cout > NARROW_COUT and wd <= DEEP_MAX_W and wd % 32 != 0:
            return "deep_tensor_cores"
        return "tensor_cores"
    if wd % 2 == 0 and dtype == torch.float32:
        if (cout <= NARROW_COUT and cin % NF_CHANNELS == 0
                and 4 * cin * 27 * _narrow_co(cout) + NF_RAW_BYTES
                <= SMEM_BYTES):
            return "narrow_cuda_cores"
        if cin % XF_CHANNELS == 0:
            return "tensor_cores_3xtf32"
    return "cuda_cores"


def narrow_planes(dtype: torch.dtype, b: int, cout: int, d: int, h: int,
                  wd: int) -> int:
    """Output planes a block of the narrow designs owns (its slab): in f32
    10 / CO (CO = Cout padded to 2, 4 or 8: the slab's sums stay in
    registers); in bf16 (whose sums leave the registers a plane at a time)
    the slab that minimises the waves of blocks (b x 10 x 32-voxel tile
    columns x slabs over one block an SM) times the planes a block stages
    (nz + 2)."""
    if dtype != torch.bfloat16:
        return 10 // _narrow_co(cout)
    tiles = b * (-(-h // 10)) * (-(-wd // 32))
    best = None
    for s in range(1, d + 1):
        nz = -(-d // s)
        cost = -(-(tiles * -(-d // nz)) // SMS) * (nz + 2)
        if best is None or cost < best[0]:
            best = (cost, nz)
    return best[1]


def narrow_slabs(dtype: torch.dtype, b: int, cout: int, d: int, h: int,
                 wd: int) -> list:
    """The (z0, z1) output planes of each block of a tile column in the
    narrow designs (``narrow_planes`` a slab, the last cut at D): they
    cover the D planes once, in order."""
    nz = narrow_planes(dtype, b, cout, d, h, wd)
    return [(z, min(d, z + nz)) for z in range(0, d, nz)]


def deep_tile(cout: int, h: int, wd: int) -> tuple:
    """The deep design's tile for Cout, H and W: (BN, M, yb). BN, the
    column tile, is 64 up to Cout = 64 and 128 above (256 takes two);
    M, the voxel rows a block, is 512 up to BN = 64 and 256 at 128 (the
    f32 sums a thread); yb, the output rows a block, is as many as the
    padded, flattened rows (yb - 1) * (W + 2) + W fit in M, evened out
    over the tiles that cover H."""
    bn = 64 if cout <= 64 else 128
    m = 512 if bn == 64 else 256
    yb_max = (m - wd) // (wd + 2) + 1
    y_tiles = -(-h // yb_max)
    return bn, m, -(-h // y_tiles)


def tc_splits(b: int, cin: int, cout: int, d: int, h: int, wd: int) -> int:
    """Runs of Cin chunks (16 channels) the deep design splits a conv
    into, summed in a fixed order by a second kernel: 1 when its tiles
    (``deep_tile``'s yb rows of a plane x BN columns) already give a block
    to every SM, else as many runs (whole chunks, none empty) as keep
    the blocks within one a SM."""
    bn, _, yb = deep_tile(cout, h, wd)
    tiles = b * d * (-(-h // yb)) * (-(-cout // bn))
    chunks = cin // TC_CHANNELS
    if tiles >= SMS or chunks < 2:
        return 1
    per = -(-chunks // min(chunks, SMS // tiles))
    return -(-chunks // per)


def pack_weight(w: torch.Tensor) -> torch.Tensor:
    """(Cout, Cin, 3, 3, 3) -> (Cin / 16, 27, Np, 16) in w's type, Np =
    Cout rounded up to 8: ``wp[c // 16, dz * 9 + dy * 3 + dx, o, c % 16] =
    w[o, c, dz, dy, dx]``, zeros for o >= Cout."""
    cout, cin = w.shape[:2]
    np_ = -(-cout // 8) * 8
    packed = w.reshape(
        cout, cin // TC_CHANNELS, TC_CHANNELS, 27).permute(1, 3, 0, 2)
    if np_ == cout:                    # one copy, no zero fill
        return packed.contiguous()
    wp = torch.zeros((cin // TC_CHANNELS, 27, np_, TC_CHANNELS),
                     dtype=w.dtype, device=w.device)
    wp[:, :, :cout] = packed
    return wp


def pack_weight_xf(w: torch.Tensor) -> torch.Tensor:
    """The 3xTF32 kernel's weight layout, before its TF32 split (its
    packing kernel's plain form): (Cout, Cin, 3, 3, 3) -> (Cin / 8, 3, T,
    9, BN * 8), BN = ``xf_tile_n(Cout)``, T = ceil(Cout / BN): one
    contiguous block of 9 (dy, dx) taps x BN x 8 a stage (8 input
    channels, one dz) and column tile, each BN x 8 block in 8 x 16-byte
    core-matrix order, element (n, k) at ((n // 8) * 2 + k // 4) * 32 + (n
    % 8) * 4 + k % 4; zeros for output channels >= Cout."""
    cout, cin = w.shape[:2]
    bn = xf_tile_n(cout)
    nt = -(-cout // bn)
    ck = XF_CHANNELS
    wl = torch.zeros((cin // ck, 27, nt * bn, ck), dtype=w.dtype,
                     device=w.device)
    wl[:, :, :cout] = w.reshape(cout, cin // ck, ck, 27).permute(1, 3, 0, 2)
    # (chunk, dz, tap, tile, n // 8, n % 8, k // 4, k % 4), then the
    # stage's taps and core matrices innermost
    v = wl.reshape(cin // ck, 3, 9, nt, bn // 8, 8, 2, 4)
    return v.permute(0, 1, 3, 2, 4, 6, 5, 7).reshape(
        cin // ck, 3, nt, 9, bn * ck)


def split_tf32(x: torch.Tensor):
    """f32 -> (hi, lo) f32 tensors as the 3xTF32 kernel splits each
    operand: ``hi`` is x rounded to TF32 as ``cvt.rna.tf32.f32`` rounds
    (10 mantissa bits, ties away from zero, the low 13 bits zero), ``lo``
    is ``x - hi`` rounded the same way. hi + lo = x within 2^-22 |x|."""
    def rna(v):
        bits = v.contiguous().view(torch.int32).long() & 0xFFFFFFFF
        mag = bits & 0x7FFFFFFF
        keep = mag >= 0x7F800000                     # inf and nan
        mag = torch.where(keep, mag, (mag + 0x1000) & ~0x1FFF)
        bits = (bits & 0x80000000) | mag
        return torch.where(bits >= 1 << 31, bits - (1 << 32), bits).to(
            torch.int32).view(torch.float32)

    hi = rna(x.float())
    return hi, rna(x.float() - hi)


def xf_tile_n(cout: int) -> int:
    """The 3xTF32 kernel's column tile BN: 8, 16 or 32, the least that
    holds Cout, up to 32 output channels; 64 above."""
    np_ = -(-cout // 8) * 8
    return next(n for n in (8, 16, 32, 64) if np_ <= n or n == 64)


def conv_splits(b: int, cin: int, cout: int, d: int, h: int, wd: int) -> int:
    """Runs of Cin chunks the 3xTF32 kernel splits a conv into: 1 when its
    output tiles (8 rows x 32 columns x ``xf_tile_n(cout)`` channels)
    already give ``SPLIT_BLOCKS`` blocks, else enough runs (whole chunks
    of 8 channels, none empty) to come near it."""
    bn = xf_tile_n(cout)
    tiles = (-(-wd // 32)) * (-(-h // 8)) * b * d * (-(-cout // bn))
    chunks = cin // XF_CHANNELS
    if tiles >= SPLIT_BLOCKS or chunks < 2:
        return 1
    per = -(-chunks // min(chunks, -(-SPLIT_BLOCKS // tiles)))
    return -(-chunks // per)


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


def refuse_autograd(*tensors: Optional[torch.Tensor]) -> None:
    """Raise ``RuntimeError`` when autograd records and any of
    ``tensors`` requires grad: the kernel's output would carry no
    gradient back to them."""
    if torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors
    ):
        raise RuntimeError(
            "conv3d_3x3: the conv kernel has no backward, as the "
            "reference's Pallas conv has none, and autograd needs this "
            "conv's gradient; train with POINTUNET_FASTCONV unset (the "
            "kernel serves inference under torch.inference_mode or "
            "torch.no_grad)"
        )


def conv3d_3x3(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """SAME, stride-1 3x3x3 conv (see the module docstring); x, w and
    bias of one type, f32 or bf16.

    CPU tensors take the plain version. CUDA tensors launch the kernel;
    anything the kernel does not take raises, and so does a call whose
    gradient autograd would need (``refuse_autograd``)."""
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
    refuse_autograd(*tensors)
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
    path = conv_path(x.dtype, cin, cout, wd)
    with torch.cuda.device(dev):
        if path == "tensor_cores_3xtf32":
            # scratch for the packed hi and lo weights (whole column
            # tiles), and for the runs' partial sums of a split conv
            np_ = -(-cout // 8) * 8
            bn = xf_tile_n(cout)
            wsplit = torch.empty((2, cin, 27, -(-np_ // bn) * bn),
                                 dtype=torch.float32, device=dev)
            splits = conv_splits(b, cin, cout, d, h, wd)
            partial = (None if splits == 1 else torch.empty(
                (splits,) + tuple(out.shape), dtype=torch.float32, device=dev))
            rc = lib.conv3x3_xf_launch(
                x.data_ptr(), w.data_ptr(), wsplit.data_ptr(), bias_ptr,
                out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                b, cin, cout, np_, d, h, wd, splits, stream,
            )
        elif path == "tensor_cores":
            wp = pack_weight(w)
            rc = lib.conv3x3_tc_launch(
                x.data_ptr(), wp.data_ptr(), bias_ptr, out.data_ptr(),
                b, cin, cout, wp.shape[2], d, h, wd, stream,
            )
        elif path == "narrow_tensor_cores":
            if x.data_ptr() % 16:
                raise ValueError(
                    "conv3d_3x3: the head's kernel stages x in 16-byte "
                    "vectors (cp.async); x must start 16-byte aligned")
            wp = pack_weight(w)
            rc = lib.conv3x3_nw_launch(
                x.data_ptr(), wp.data_ptr(), bias_ptr, out.data_ptr(),
                b, cin, cout, d, h, wd,
                narrow_planes(x.dtype, b, cout, d, h, wd), stream,
            )
        elif path == "narrow_cuda_cores":
            rc = lib.conv3x3_nf_launch(
                x.data_ptr(), w.data_ptr(), bias_ptr, out.data_ptr(),
                b, cin, cout, d, h, wd, stream,
            )
        elif path == "deep_tensor_cores":
            wp = pack_weight(w)
            yb = deep_tile(cout, h, wd)[2]
            splits = tc_splits(b, cin, cout, d, h, wd)
            partial = (None if splits == 1 else torch.empty(
                (splits,) + tuple(out.shape), dtype=torch.float32, device=dev))
            rc = lib.conv3x3_dp_launch(
                x.data_ptr(), wp.data_ptr(), bias_ptr, out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                b, cin, cout, wp.shape[2], d, h, wd, yb, splits, stream,
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
