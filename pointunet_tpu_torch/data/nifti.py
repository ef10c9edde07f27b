"""Minimal NIfTI-1 reader/writer (pure numpy + gzip).

A copy of ``pointunet_tpu/data/nifti.py``, so that the port needs nothing
of the JAX package (tests/test_torch_data.py holds the two equal). It
implements the small subset Point-Unet needs: single-file .nii / .nii.gz,
scalar voxel types, optional affine.

Layout convention: data is returned in Fortran-order indexing (x, y, z) —
the same as nibabel's ``get_fdata``/``dataobj`` — so downstream code keeps
the reference's axis semantics.
"""
from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field

import numpy as np

_DTYPES = {
    2: np.uint8,
    4: np.int16,
    8: np.int32,
    16: np.float32,
    64: np.float64,
    256: np.int8,
    512: np.uint16,
    768: np.uint32,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclass
class Nifti1Image:
    data: np.ndarray
    affine: np.ndarray = field(
        default_factory=lambda: np.eye(4, dtype=np.float32)
    )
    spacing: tuple = (1.0, 1.0, 1.0)   # voxel size per spatial axis (mm)

    @property
    def shape(self):
        return self.data.shape

    def get_fdata(self) -> np.ndarray:
        return np.asarray(self.data, dtype=np.float64)


def _open(path: str, mode: str):
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


def load(path: str) -> Nifti1Image:
    with _open(path, "rb") as f:
        raw = f.read()
    hdr = raw[:348]
    (sizeof_hdr,) = struct.unpack("<i", hdr[0:4])
    if sizeof_hdr != 348:
        raise ValueError(f"{path}: not a NIfTI-1 file (sizeof_hdr={sizeof_hdr})")
    dim = struct.unpack("<8h", hdr[40:56])
    ndim = dim[0]
    shape = tuple(dim[1 : 1 + ndim])
    (datatype,) = struct.unpack("<h", hdr[70:72])
    (vox_offset,) = struct.unpack("<f", hdr[108:112])
    (scl_slope,) = struct.unpack("<f", hdr[112:116])
    (scl_inter,) = struct.unpack("<f", hdr[116:120])
    srow = np.frombuffer(hdr[280:328], dtype="<f4").reshape(3, 4)
    affine = np.eye(4, dtype=np.float32)
    (sform_code,) = struct.unpack("<h", hdr[254:256])
    if sform_code > 0:
        affine[:3, :] = srow
    dtype = _DTYPES.get(datatype)
    if dtype is None:
        raise ValueError(f"{path}: unsupported NIfTI datatype code {datatype}")
    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=np.dtype(dtype).newbyteorder("<"),
        count=count, offset=int(vox_offset),
    )
    data = data.reshape(shape, order="F")
    if scl_slope not in (0.0, 1.0) or scl_inter != 0.0:
        slope = scl_slope if scl_slope != 0.0 else 1.0
        data = data * slope + scl_inter
    pixdim = struct.unpack("<8f", hdr[76:108])
    spacing = tuple(abs(p) or 1.0 for p in pixdim[1:4])
    return Nifti1Image(np.ascontiguousarray(data), affine, spacing)


def save(img: Nifti1Image | np.ndarray, path: str, affine=None) -> None:
    if isinstance(img, np.ndarray):
        img = Nifti1Image(img, np.eye(4, dtype=np.float32))
    if affine is not None:
        img = Nifti1Image(img.data, np.asarray(affine, dtype=np.float32))
    data = np.asarray(img.data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if data.dtype == np.int64:
        data = data.astype(np.int32)
    if data.dtype == np.float16:
        data = data.astype(np.float32)
    code = _CODES.get(data.dtype)
    if code is None:
        data = data.astype(np.float32)
        code = _CODES[data.dtype]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    dims = [data.ndim] + list(data.shape) + [1] * (7 - data.ndim)
    struct.pack_into("<8h", hdr, 40, *dims)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)  # bitpix
    # pixdim: qfac + spatial spacings
    sp = tuple(img.spacing) + (1.0,) * (7 - len(img.spacing))
    struct.pack_into("<8f", hdr, 76, 1.0, *sp)
    struct.pack_into("<f", hdr, 108, 352.0)  # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)    # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)    # scl_inter
    struct.pack_into("<h", hdr, 252, 0)      # qform_code
    struct.pack_into("<h", hdr, 254, 1)      # sform_code
    aff = np.asarray(img.affine, dtype="<f4")
    hdr[280:328] = aff[:3, :].tobytes()
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(
        order="F"
    )
    with _open(path, "wb") as f:
        f.write(payload)
