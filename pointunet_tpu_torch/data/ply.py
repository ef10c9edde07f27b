"""Binary little-endian PLY point-cloud I/O (``pointunet_tpu/data/ply.py``).

numpy structured arrays; only the subset Point-Unet uses is supported:
binary_little_endian, one 'vertex' element, scalar properties.
"""
from __future__ import annotations

import numpy as np

_PLY_TO_NP = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}
_NP_TO_PLY = {
    "int8": "char", "uint8": "uchar",
    "int16": "short", "uint16": "ushort",
    "int32": "int", "uint32": "uint",
    "float32": "float", "float64": "double",
}


def read_ply(path: str) -> np.ndarray:
    """Read a binary PLY into a structured array keyed by property name."""
    with open(path, "rb") as f:
        line = f.readline().strip()
        if line != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        count = 0
        props: list[tuple[str, str]] = []
        in_vertex = False
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tokens = line.strip().decode("ascii").split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    count = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                props.append((tokens[2], _PLY_TO_NP[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if fmt != "binary_little_endian":
            raise ValueError(f"{path}: unsupported PLY format {fmt}")
        dtype = np.dtype([(name, "<" + t) for name, t in props])
        return np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype)


def write_ply(path: str, field_list, field_names) -> None:
    """Write a binary PLY. ``field_list``: arrays (N,) or (N, k) whose
    columns map onto ``field_names`` in order."""
    if not isinstance(field_list, (list, tuple)):
        field_list = [field_list]
    columns = []
    for fld in field_list:
        arr = np.asarray(fld)
        if arr.ndim == 1:
            columns.append(arr)
        else:
            columns.extend(arr[:, i] for i in range(arr.shape[1]))
    if len(columns) != len(field_names):
        raise ValueError(
            f"{len(columns)} columns but {len(field_names)} field names"
        )
    n = len(columns[0])
    if any(len(c) != n for c in columns):
        raise ValueError("all fields must have the same length")

    dtype = np.dtype(
        [
            (name, "<" + np.dtype(col.dtype).str[1:])
            for name, col in zip(field_names, columns)
        ]
    )
    rec = np.empty(n, dtype=dtype)
    for name, col in zip(field_names, columns):
        rec[name] = col

    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    for name, col in zip(field_names, columns):
        header.append(
            f"property {_NP_TO_PLY[np.dtype(col.dtype).name]} {name}"
        )
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(rec.tobytes())
