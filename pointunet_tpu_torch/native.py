"""Native host point ops (``pointunet_tpu/native.py``): a KD-tree KNN,
its batched form, coverage-greedy query picking and grid subsampling,
from ``csrc/pointops.cpp`` (the port's copy of the reference's
``csrc/pointops.cpp``) through ctypes.

The library is built at the first call, with ``$CXX`` or ``g++``
(``ops/cuda_build.py:build_host``; with OpenMP where the compiler and
host have it), into ``pointunet_tpu_torch/_build/``. ``available()`` is
False when there is no C++ compiler or no build loads; then every
function raises with the reason. The card never calls this. Unlike the
reference, ``ops/subsample.py:grid_subsample`` keeps to numpy: this
library's grid subsampling orders cells by its hash map, sums in f32,
and is slower than numpy on one thread.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np

from .ops import cuda_build

SOURCE = cuda_build.CSRC / "pointops.cpp"


@functools.lru_cache(maxsize=1)
def _load() -> Tuple[Optional[ctypes.CDLL], str]:
    """(the typed library, "") or (None, why it is not available)."""
    try:
        lib = ctypes.CDLL(str(cuda_build.build_host(SOURCE)))
    except RuntimeError as e:
        return None, str(e)
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.pointops_knn.restype = None
    lib.pointops_knn.argtypes = [
        f32p, ctypes.c_int, f32p, ctypes.c_int, ctypes.c_int, i32p
    ]
    lib.pointops_knn_batch.restype = None
    lib.pointops_knn_batch.argtypes = [
        f32p, f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, i32p,
    ]
    lib.pointops_knn_distance_pick_batch.restype = None
    lib.pointops_knn_distance_pick_batch.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_uint64, f32p, i32p,
    ]
    lib.pointops_num_threads.restype = ctypes.c_int
    lib.pointops_num_threads.argtypes = []
    lib.pointops_grid_subsample.restype = ctypes.c_int
    lib.pointops_grid_subsample.argtypes = [
        f32p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int,
        ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]
    return lib, ""


def available() -> bool:
    """Whether the library can be used (built at the first call)."""
    return _load()[0] is not None


def _lib() -> ctypes.CDLL:
    lib, why = _load()
    if lib is None:
        raise RuntimeError(f"the native point ops are not available: {why}")
    return lib


def num_threads() -> int:
    """The library's OpenMP threads (1 when it was built without
    OpenMP)."""
    return _lib().pointops_num_threads()


def knn(support: np.ndarray, query: np.ndarray, k: int) -> np.ndarray:
    """Host KD-tree KNN: (Ns, 3), (Nq, 3) -> (Nq, k) int32, nearest
    first."""
    lib = _lib()
    support = np.ascontiguousarray(support, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    out = np.empty((query.shape[0], k), np.int32)
    lib.pointops_knn(support, support.shape[0], query, query.shape[0], k, out)
    return out


def knn_batch(support: np.ndarray, query: np.ndarray, k: int) -> np.ndarray:
    """(B, Ns, 3), (B, Nq, 3) -> (B, Nq, k) int32 (the reference's
    ``nearest_neighbors.knn_batch``)."""
    lib = _lib()
    support = np.ascontiguousarray(support, np.float32)
    query = np.ascontiguousarray(query, np.float32)
    b, ns, _ = support.shape
    nq = query.shape[1]
    out = np.empty((b, nq, k), np.int32)
    lib.pointops_knn_batch(support, query, b, ns, nq, k, out)
    return out


def knn_batch_distance_pick(pts: np.ndarray, nqueries: int, k: int,
                            seed: int = 0):
    """Coverage-greedy query picking + KNN (the reference's
    ``nearest_neighbors.knn_batch_distance_pick``): (B, N, 3) -> ((B, nq,
    3) picked queries, (B, nq, k) neighbour indices); deterministic given
    ``seed``."""
    lib = _lib()
    pts = np.ascontiguousarray(pts, np.float32)
    b, n, _ = pts.shape
    queries = np.empty((b, nqueries, 3), np.float32)
    idx = np.empty((b, nqueries, k), np.int32)
    lib.pointops_knn_distance_pick_batch(
        pts, b, n, nqueries, k, ctypes.c_uint64(seed), queries, idx
    )
    return queries, idx


def grid_subsample(points, features=None, labels=None, grid_size=0.1):
    """Grid subsampling with ``ops/subsample.py:grid_subsample``'s return
    arity. Cells come in the library's hash-map order, and points and
    features are f32 running sums over a cell's members divided by their
    count (the numpy path sums in f64, cells in ascending id): the same
    cells, values within f32 rounding, the same majority labels."""
    lib = _lib()
    points = np.ascontiguousarray(points, np.float32)
    n = points.shape[0]
    feats = (
        np.ascontiguousarray(features, np.float32)
        if features is not None
        else None
    )
    fdim = 0 if feats is None else feats.shape[1]
    labs = (
        np.ascontiguousarray(labels, np.int32).reshape(-1)
        if labels is not None
        else None
    )
    n_classes = int(labs.max()) + 1 if labs is not None and labs.size else 0

    def ptr(a):
        return a.ctypes.data_as(ctypes.c_void_p) if a is not None else None

    m = lib.pointops_grid_subsample(
        points, n, ptr(feats), fdim, ptr(labs), n_classes,
        ctypes.c_float(grid_size), 1, None, None, None,
    )
    out_points = np.empty((m, 3), np.float32)
    out_feats = np.empty((m, fdim), np.float32) if feats is not None else None
    out_labs = np.empty((m,), np.int32) if labs is not None else None
    lib.pointops_grid_subsample(
        points, n, ptr(feats), fdim, ptr(labs), n_classes,
        ctypes.c_float(grid_size), 0,
        out_points.ctypes.data_as(ctypes.c_void_p),
        ptr(out_feats), ptr(out_labs),
    )
    out = [out_points]
    if feats is not None:
        out.append(out_feats)
    if labs is not None:
        out.append(out_labs)
    return out[0] if len(out) == 1 else tuple(out)
