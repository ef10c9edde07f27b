"""Cell-window KNN: the hand-written CUDA kernel and its plain version.

Replaces ``pointunet_tpu/ops/knn_pallas.py:knn_pallas_core`` (kernel body
``_kernel_factory``), the one TPU kernel on the fused inference path: the
pyramid calls it for the self-KNN and the 1-NN up search of every level
larger than ``GRID_THRESHOLD`` points (ops/pyramid.py).

Inputs follow the sorted-pyramid contract: support and queries are sorted
by raster cell id ``(cx * r + cy) * r + cz`` of one grid, ``cell_start``
holds the support's cell prefix sums, and the result is (Nq, k) int32 rows
of the sorted support. Candidates are the support rows in the 27 cells
around the query's cell, read as 9 exact (dx, dy) spans with a z-halo of
1; neighbours come nearest first, ties to the lower row, and a slot with
no neighbour takes the first neighbour found (row 0 if none).

* ``knn_cell_window_plain`` computes that in plain torch, chunked over
  queries. The CPU path and the comparison on the card use it.
* ``knn_cell_window`` is the wrapper: the plain version for CPU tensors;
  for CUDA tensors it launches the kernel of ``csrc/knn_cell_window.cu``
  or raises. ``LAUNCHES`` counts its kernel launches.
* ``knn_pallas(support, query, k)`` is the standalone entry of the
  reference's ``knn_pallas``: it sorts two clouds in any row order on
  their own grid, runs ``knn_cell_window`` and returns the rows in the
  caller's order. Not to be confused with ``knn_window.knn_cell_window``,
  the reference's approximate search of XLA ops, ported in plain torch.
* ``tile_windows_plain`` is the kernel's tile plan in plain torch: for
  each block of ``TILE`` sorted queries and each (dx, dy), the union of
  the queries' spans, which the kernel stages in shared memory
  ``CHUNK[k]`` rows at a time.

The kernel's source note says what bounds it on the H100 and how its
design answers that. The library is built and loaded by
``ops/cuda_build.py`` at first use.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from ..core import trace
from . import cuda_build
from .knn import pad_k_columns
from .knn_window import _grid_resolution

# kernel launches made by ``knn_cell_window`` in this process
LAUNCHES = 0

# the k the kernel is instantiated for: the pyramid's self search (16)
# and up search (1); the plain version takes any k
KERNEL_KS = (1, 16)
PLAIN_CHUNK = 4096      # queries per candidate block of the plain version
# the kernel's tile plan (KNN_TILE, KNN_CHUNK and KNN_UP_CHUNK of the
# source): sorted queries a block, support rows a shared-memory ring slot
# for each k
TILE = 64
CHUNK = {16: 2048, 1: 1024}
SOURCE = cuda_build.CSRC / "knn_cell_window.cu"
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]

# the 9 (dx, dy) column offsets in ascending sorted-row order
_OFFSETS = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return cuda_build.load(SOURCE, "knn_cell_window_launch", _ARGTYPES)


def cell_prefix_sums(ids_sorted: torch.Tensor, r: int) -> torch.Tensor:
    """(r^3 + 1,) int32 ``cell_start``: rows of cell c are
    ``cell_start[c] .. cell_start[c + 1]`` of the id-sorted cloud."""
    counts = torch.bincount(ids_sorted.long(), minlength=r * r * r)
    trace.count("host_sync", 2)          # bincount reads the ids' min and max
    out = torch.zeros(r * r * r + 1, dtype=torch.int32, device=ids_sorted.device)
    out[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return out


def _spans(qc: torch.Tensor, cell_start: torch.Tensor, r: int):
    """(start, length) of the 9 (dx, dy) spans of each query, (Q, 9)."""
    off = torch.tensor(_OFFSETS, dtype=torch.long, device=qc.device)
    qc = qc.long()
    x = qc[:, 0:1] + off[:, 0]
    y = qc[:, 1:2] + off[:, 1]
    inside = (x >= 0) & (x < r) & (y >= 0) & (y < r)
    z0 = (qc[:, 2:3] - 1).clamp(min=0)
    z1 = (qc[:, 2:3] + 1).clamp(max=r - 1)
    base = (x.clamp(0, r - 1) * r + y.clamp(0, r - 1)) * r
    start = cell_start[base + z0].long()
    end = cell_start[base + z1 + 1].long()
    length = torch.where(inside & (z0 <= z1), end - start, 0)
    return start, length


def tile_windows_plain(
    qc: torch.Tensor, cell_start: torch.Tensor, r: int, tile: int = TILE
) -> torch.Tensor:
    """(ceil(Nq / tile), 9, 2) int64 ``[lo, hi)`` support rows a tile of
    ``tile`` sorted queries stages for each (dx, dy) of ``_OFFSETS``: the
    least start and the greatest end of its queries' non-empty spans
    ([0, 0) where all are empty). Every span of every query of the tile
    lies inside its window."""
    start, length = _spans(qc, cell_start, r)
    end = start + length
    n_tiles = -(-qc.shape[0] // tile)
    pad = n_tiles * tile - qc.shape[0]
    empty = F.pad(length == 0, (0, 0, 0, pad), value=True)
    big = torch.iinfo(torch.int64).max
    lo = F.pad(start, (0, 0, 0, pad)).masked_fill(empty, big)
    hi = F.pad(end, (0, 0, 0, pad)).masked_fill(empty, -1)
    lo = lo.view(n_tiles, tile, 9).amin(1)
    hi = hi.view(n_tiles, tile, 9).amax(1)
    none = hi < 0
    return torch.stack([lo.masked_fill(none, 0), hi.masked_fill(none, 0)], -1)


def knn_cell_window_plain(
    sp: torch.Tensor,          # (Ns, 3) f32 support, cell-id sorted
    cell_start: torch.Tensor,  # (r^3 + 1,) int32 prefix sums
    qp: torch.Tensor,          # (Nq, 3) f32 queries, cell-id sorted
    qc: torch.Tensor,          # (Nq, 3) int32 query cells
    k: int,
    r: int,
) -> torch.Tensor:
    """The kernel's function in plain torch: (Nq, k) int32 sorted-support
    rows. Candidates of a query chunk are laid out span after span in
    ascending row order; a stable sort by d^2 then orders them by
    (d^2, row), as the kernel's insertion list does."""
    nq = qp.shape[0]
    out = torch.zeros((nq, k), dtype=torch.int32, device=qp.device)
    for q0 in range(0, nq, PLAIN_CHUNK):
        q = qp[q0:q0 + PLAIN_CHUNK]
        start, length = _spans(qc[q0:q0 + PLAIN_CHUNK], cell_start, r)
        cum = torch.cumsum(length, 1)                       # (Q, 9)
        total = cum[:, -1]
        width = int(total.max()) if total.numel() else 0
        if width == 0:
            continue                                        # all rows -> 0
        j = torch.arange(width, device=qp.device).expand(q.shape[0], width)
        grp = torch.searchsorted(cum, j.contiguous(), right=True).clamp(max=8)
        valid = j < total[:, None]
        row = start.gather(1, grp) + j - (cum - length).gather(1, grp)
        row = torch.where(valid, row, 0)
        s = sp[row]                                         # (Q, W, 3)
        ex = q[:, None, 0] - s[..., 0]
        ey = q[:, None, 1] - s[..., 1]
        ez = q[:, None, 2] - s[..., 2]
        d2 = ex * ex + ey * ey + ez * ez
        d2 = torch.where(valid, d2, torch.inf)
        kk = min(k, width)
        dsort, pos = torch.sort(d2, dim=1, stable=True)
        idx = row.gather(1, pos[:, :kk])
        found = torch.isfinite(dsort[:, :kk])
        if kk < k:
            pad = k - kk
            idx = torch.cat([idx, idx.new_zeros((idx.shape[0], pad))], 1)
            found = torch.cat([found, found.new_zeros((found.shape[0], pad))], 1)
        first = torch.where(found[:, :1], idx[:, :1], 0)
        out[q0:q0 + PLAIN_CHUNK] = torch.where(found, idx, first).to(torch.int32)
    return out


def knn_cell_window(
    sp: torch.Tensor,
    cell_start: torch.Tensor,
    qp: torch.Tensor,
    qc: torch.Tensor,
    k: int,
    r: int,
) -> torch.Tensor:
    """Cell-window KNN over sorted clouds (see the module docstring).

    CPU tensors take the plain version. CUDA tensors launch the kernel;
    anything the kernel does not take raises."""
    global LAUNCHES
    tensors = (sp, cell_start, qp, qc)
    if all(t.device.type == "cpu" for t in tensors):
        return knn_cell_window_plain(sp, cell_start, qp, qc, k, r)
    dev = sp.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "knn_cell_window: inputs must all be on the CPU or all on one "
            f"CUDA device, got {[str(t.device) for t in tensors]}"
        )
    ns, nq = sp.shape[0], qp.shape[0]
    if k not in KERNEL_KS:
        raise ValueError(
            f"knn_cell_window: the kernel takes k in {KERNEL_KS}, got {k}"
        )
    if ns < 1:
        raise ValueError("knn_cell_window: empty support")
    for name, t, dt, shape in (
        ("sp", sp, torch.float32, (ns, 3)),
        ("qp", qp, torch.float32, (nq, 3)),
        ("qc", qc, torch.int32, (nq, 3)),
        ("cell_start", cell_start, torch.int32, (r * r * r + 1,)),
    ):
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"knn_cell_window: {name} must be contiguous {dt} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    if sp.data_ptr() % 16:
        raise ValueError(
            "knn_cell_window: sp must start 16-byte aligned (the kernel "
            "stages its rows with 16-byte copies)"
        )
    out = torch.empty((nq, k), dtype=torch.int32, device=dev)
    fn = load_library().knn_cell_window_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(
            sp.data_ptr(), cell_start.data_ptr(), qp.data_ptr(),
            qc.data_ptr(), out.data_ptr(), ns, nq, k, r, stream,
        )
    if rc != 0:
        raise RuntimeError(f"knn_cell_window: kernel launch failed, CUDA error {rc}")
    LAUNCHES += 1
    return out


def knn_pallas(
    support: torch.Tensor,
    query: torch.Tensor,
    k: int,
    alpha: float = 1.8,
    tile: int = 128,
    slack: float = 4.0,
) -> torch.Tensor:
    """Cell-window KNN of two clouds in any row order (the reference's
    standalone ``knn_pallas``): (Nq, k) int32 indices into ``support``,
    nearest first, in the caller's query order; columns beyond the
    support's size repeat the last (``pad_k_columns``).

    Both clouds are sorted (stably) by raster cell id on the support's
    ``alpha``-scaled grid; ``knn_cell_window`` searches them (kernel 1 on
    CUDA tensors, its plain version on the CPU) and the rows are mapped
    back to the caller's support rows and query order. Within the 27
    cells around a query the neighbours are exact, so ``tile`` and
    ``slack``, which size the reference's fixed windows, are accepted for
    its signature and change nothing. The kernel is instantiated for k
    in ``KERNEL_KS``: a smaller k runs the next one up and keeps its
    first columns (the same neighbours)."""
    support = support.float()
    query = query.float()
    ns = int(support.shape[0])
    k_req, k = k, min(k, ns)
    r = _grid_resolution(ns, alpha)
    lo = support.amin(0)
    span = torch.clamp(support.amax(0) - lo, min=1e-6)

    def cell3(pts):
        return torch.clamp(torch.floor((pts - lo) / span * r), 0, r - 1
                           ).to(torch.int32)

    sc3 = cell3(support)
    s_ids = (sc3[:, 0] * r + sc3[:, 1]) * r + sc3[:, 2]
    s_order = torch.argsort(s_ids, stable=True)
    qc3 = cell3(query)
    q_ids = (qc3[:, 0] * r + qc3[:, 1]) * r + qc3[:, 2]
    q_order = torch.argsort(q_ids, stable=True)
    k_run = k
    if support.device.type == "cuda":
        k_run = min((kk for kk in KERNEL_KS if kk >= k), default=k)
    idx_sorted = knn_cell_window(
        support[s_order].contiguous(),
        cell_prefix_sums(s_ids[s_order], r),
        query[q_order].contiguous(), qc3[q_order].contiguous(), k_run, r,
    )[:, :k]
    out = torch.empty_like(idx_sorted)
    out[q_order] = s_order[idx_sorted.long()].to(torch.int32)
    return pad_k_columns(out, k_req)
