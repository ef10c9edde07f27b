"""Sorted-contract gather gradient: kernel 2 and its plain version
(``pointunet_tpu/ops/scatter_sorted.py``).

The gradient of a K-neighbour row gather ``table[idx]`` is a scatter-add
of the (Nq, K, C) cotangents into (Ns, C) rows. When ``idx`` came from
the pyramid's cell-window search, every neighbour lies in the 27 cells
around its query, so a tile of ``S_TILE`` consecutive sorted support rows
can only receive rows from 9 contiguous ranges of the cell-sorted
queries, read from the query cell prefix sums. ``scatter_sorted`` sums
along that plan, reading ct in its own type (f32 or bf16) and summing in
f32:

* ``scatter_sorted_plain`` in plain torch, tile by tile over the same
  ranges. The CPU path and the comparison on the card use it.
* ``scatter_sorted`` is the wrapper: the plain version for CPU tensors;
  for CUDA tensors it launches the kernel of ``csrc/scatter_sorted.cu``
  (exact, no atomics, bitwise deterministic: each tile lists its hits,
  sorts them by row and sums each row in ascending flat row) or raises.
  ``LAUNCHES`` counts its kernel launches.

``scatter_add_sorted`` recomputes the search's cells from the level-0
grid; for a pool gather (``query_sorted=False``) it sorts the queries'
cells and indices and passes the permutation, through which the kernel
reads ct in place (no sorted copy of ct). ``sorted_gather`` is the row
gather whose backward runs it above the size gate and, below it, where
the reference runs XLA's scatter, ``gather.row_sum``: a stable sort of
the indices and one f32 sum a row in that order, so that the gradient
has the same bits on every run, as the kernel's has. Indices that did
not come from the windowed search (levels at or below ``GRID_THRESHOLD``
points, searched brute force) may lie outside the 27 cells: the gate
keeps them off the planned path.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core import trace
from . import cuda_build
from .gather import gather_neighbour, row_sum
from .knn_cuda import cell_prefix_sums
from .pyramid import GRID_THRESHOLD

# kernel launches made by ``scatter_sorted`` in this process
LAUNCHES = 0

S_TILE = 128             # support rows a tile (the kernel's kTile, the
                         # reference's S_TILE)
# below this many flat rows the backward takes index_add_; a test may
# lower it, but only for indices from the windowed search
MIN_ROWS = 262_144
PLAIN_ROWS = 1 << 24     # scanned flat rows a pass of the plain version
TIMED_EVERY = 4          # the tracer records the backward's span in one
                         # record of every TIMED_EVERY
SOURCE = cuda_build.CSRC / "scatter_sorted.cu"
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def load_library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    return cuda_build.load(SOURCE, "scatter_sorted_launch", _ARGTYPES)


def _cells_at_level(
    xyz: torch.Tensor, lo: torch.Tensor, span: torch.Tensor, r0: int,
    level: int,
) -> Tuple[torch.Tensor, int]:
    """The pyramid's cell ids at ``level``, recomputed in its f32
    operation order: floor((xyz - lo) / span * r0), clip, >> level."""
    c3 = torch.floor((xyz - lo) / span * r0).to(torch.int32)
    c3 = c3.clamp(0, r0 - 1) >> level
    r = ((r0 - 1) >> level) + 1
    return (c3[:, 0] * r + c3[:, 1]) * r + c3[:, 2], r


def _windows(
    s_ids: torch.Tensor, q_cell_start: torch.Tensor, k: int, r: int
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per tile, the 9 flat-row ranges [start, end) the tile reads, in
    descending column offset (ascending starts and ends), each start
    clipped to the end already covered: (nt, 9) int64 each."""
    ns = s_ids.shape[0]
    dev = s_ids.device
    v = r * r * r
    first = torch.arange(0, ns, S_TILE, device=dev)
    last = (first + S_TILE - 1).clamp(max=ns - 1)
    c_lo = s_ids[first].long()[:, None]
    c_hi = s_ids[last].long()[:, None]
    offs = torch.tensor(
        sorted((dx * r * r + dy * r for dx in (-1, 0, 1) for dy in (-1, 0, 1)),
               reverse=True),
        dtype=torch.long, device=dev,
    )
    qcs = q_cell_start.long()
    start = qcs[(c_lo - offs - 1).clamp(0, v)] * k
    end = qcs[(c_hi - offs + 2).clamp(0, v)] * k
    covered = torch.cummax(end, dim=1).values
    prev = torch.cat([torch.zeros_like(covered[:, :1]), covered[:, :-1]], 1)
    start = torch.maximum(start, prev)
    return start, torch.maximum(end, start)


def window_passes(starts: torch.Tensor, length: torch.Tensor):
    """The flat rows of the windows ``[starts, starts + length)``, in
    window order, in passes of whole windows of about ``PLAIN_ROWS``
    rows: yields (window id, flat row) per row, int64."""
    dev = starts.device
    cum = torch.cumsum(length, 0)
    w0 = 0
    while w0 < length.numel():
        base = int(cum[w0 - 1]) if w0 else 0
        w1 = int(torch.searchsorted(cum, base + PLAIN_ROWS, right=True))
        w1 = max(w1, w0 + 1)
        lens = length[w0:w1]
        win = torch.repeat_interleave(torch.arange(w0, w1, device=dev), lens)
        pos = torch.arange(win.numel(), device=dev) - (
            torch.cumsum(lens, 0) - lens
        ).repeat_interleave(lens)
        yield win, starts[win] + pos
        w0 = w1


def scatter_sorted_plain(
    ct: torch.Tensor,            # (Nq * K, C) f32 or bf16 rows
    idx: torch.Tensor,           # (Nq * K,) int32 sorted-support rows
    s_ids: torch.Tensor,         # (Ns,) int32 sorted support cell ids
    q_cell_start: torch.Tensor,  # (r^3 + 1,) int32 query prefix sums
    k: int,
    r: int,
    q_perm: Optional[torch.Tensor] = None,  # (Nq,) int32 or None
) -> torch.Tensor:
    """The kernel's function in plain torch: (Ns, C) f32. Every tile
    lists the flat rows of its ranges and keeps those whose index falls
    in the tile, so a contribution outside the plan is dropped here as it
    is in the kernel. Flat row p of the cell-sorted queries reads ct row
    p, or ``q_perm[p // k] * k + p % k`` when ``q_perm`` is given (ct in
    the queries' own order)."""
    ns, c = s_ids.shape[0], ct.shape[1]
    out = torch.zeros((ns, c), dtype=torch.float32, device=ct.device)
    start, end = _windows(s_ids, q_cell_start, k, r)
    for win, p in window_passes(start.reshape(-1), (end - start).reshape(-1)):
        j = idx[p].long()
        lo = win // 9 * S_TILE                          # the window's tile
        keep = (j >= lo) & (j < lo + S_TILE)
        p = p[keep]
        if q_perm is not None:                    # ct in the queries' order
            p = q_perm[p // k].long() * k + p % k
        out.index_add_(0, j[keep], ct[p].float())
    return out


def scatter_sorted(
    ct: torch.Tensor,
    idx: torch.Tensor,
    s_ids: torch.Tensor,
    q_cell_start: torch.Tensor,
    k: int,
    r: int,
    q_perm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sorted-contract scatter-add (see the module docstring): (Ns, C) f32
    from f32 or bf16 ct.

    CPU tensors take the plain version. CUDA tensors launch the kernel;
    anything the kernel does not take raises."""
    global LAUNCHES
    tensors = (ct, idx, s_ids, q_cell_start) + (
        () if q_perm is None else (q_perm,))
    if all(t.device.type == "cpu" for t in tensors):
        return scatter_sorted_plain(ct, idx, s_ids, q_cell_start, k, r, q_perm)
    dev = ct.device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(
            "scatter_sorted: inputs must all be on the CPU or all on one "
            f"CUDA device, got {[str(t.device) for t in tensors]}"
        )
    ns = s_ids.shape[0]
    if ct.ndim != 2 or ns < 1 or k < 1 or ct.shape[0] % k or not ct.shape[0]:
        raise ValueError(
            f"scatter_sorted: ct must be (Nq*K, C) with K={k} and a non-"
            f"empty support, got {tuple(ct.shape)} and Ns={ns}"
        )
    if ct.dtype not in _DTYPES:
        raise ValueError(
            f"scatter_sorted: ct must be float32 or bfloat16, got {ct.dtype}")
    nqk, c = ct.shape
    checks = [
        ("ct", ct, ct.dtype, (nqk, c)),
        ("idx", idx, torch.int32, (nqk,)),
        ("s_ids", s_ids, torch.int32, (ns,)),
        ("q_cell_start", q_cell_start, torch.int32, (r * r * r + 1,)),
    ]
    if q_perm is not None:
        checks.append(("q_perm", q_perm, torch.int32, (nqk // k,)))
    for name, t, dt, shape in checks:
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"scatter_sorted: {name} must be contiguous {dt} {shape}, "
                f"got {t.dtype} {tuple(t.shape)}"
            )
    if idx.data_ptr() % 16:              # the kernel reads idx as int4
        idx = idx.clone()
    out = torch.empty((ns, c), dtype=torch.float32, device=dev)
    fn = load_library().scatter_sorted_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = fn(
            ct.data_ptr(), idx.data_ptr(),
            None if q_perm is None else q_perm.data_ptr(), s_ids.data_ptr(),
            q_cell_start.data_ptr(), out.data_ptr(), nqk // k, ns, c, k, r,
            _DTYPES[ct.dtype], stream,
        )
    if rc != 0:
        raise RuntimeError(f"scatter_sorted: kernel launch failed, CUDA error {rc}")
    LAUNCHES += 1
    return out


def scatter_add_sorted(
    ct: torch.Tensor,           # (Nq, K, C) cotangents, f32 or bf16
    idx: torch.Tensor,          # (Nq, K) int sorted-support rows
    support_xyz: torch.Tensor,  # (Ns, 3) cell-sorted at the search grid
    query_xyz: torch.Tensor,    # (Nq, 3)
    lo: torch.Tensor,           # (3,) level-0 grid origin
    span: torch.Tensor,         # (3,) level-0 grid extent
    r0: int,
    level: int,
    query_sorted: bool = True,
) -> torch.Tensor:
    """Sum the ct rows into (Ns, C) f32 along the sorted plan: the
    gradient of a row gather whose indices came from the level's
    windowed search. ct is read in its own type. ``query_sorted=False``
    (the pool gather, whose queries live in the next level's order)
    sorts the queries' cells and indices by their cell at this level,
    stably, and hands the kernel the permutation to read ct through; the
    sum does not depend on the query order."""
    nq, k, c = ct.shape
    s_ids, r = _cells_at_level(support_xyz.float(), lo, span, r0, level)
    q_ids, _ = _cells_at_level(query_xyz.float(), lo, span, r0, level)
    idx = idx.to(torch.int32)
    q_perm = None
    if not query_sorted:
        qs = torch.argsort(q_ids, stable=True)
        q_ids, idx, q_perm = q_ids[qs], idx[qs], qs.to(torch.int32)
    return scatter_sorted(
        ct.reshape(nq * k, c).contiguous(), idx.reshape(-1).contiguous(),
        s_ids.to(torch.int32).contiguous(), cell_prefix_sums(q_ids, r), k, r,
        q_perm,
    )


class SortedGather(torch.autograd.Function):
    """``table[idx]`` whose backward runs the sorted scatter above the
    size gate (``idx.numel() >= MIN_ROWS`` and ``Ns > GRID_THRESHOLD``)
    and ``gather.row_sum`` below it, both summing in f32 in a fixed
    order and casting once to ct's type. Each backward adds one to the
    tracer's counter ``gather_backward``; in one record of every
    ``TIMED_EVERY`` it is also a device span ``gather.backward`` (a BraTS
    step has 15, whose event pairs in every step would nearly double the
    tracer's host time a step)."""

    @staticmethod
    def forward(ctx, table, idx, support_xyz, query_xyz, lo, span, r0,
                level, query_sorted):
        ctx.save_for_backward(idx, support_xyz, query_xyz, lo, span)
        ctx.meta = (table.shape[0], r0, level, query_sorted)
        return gather_neighbour(table, idx)

    @staticmethod
    def backward(ctx, ct):
        idx, support_xyz, query_xyz, lo, span = ctx.saved_tensors
        n_support, r0, level, query_sorted = ctx.meta
        trace.count("gather_backward")
        with trace.span("gather.backward", device=ct.is_cuda,
                        every=TIMED_EVERY):
            if idx.numel() >= MIN_ROWS and n_support > GRID_THRESHOLD:
                grad = scatter_add_sorted(
                    ct, idx, support_xyz, query_xyz, lo, span, r0, level,
                    query_sorted,
                ).to(ct.dtype)
            else:
                grad = row_sum(ct, idx, n_support).to(ct.dtype)
        return grad, None, None, None, None, None, None, None, None


def sorted_gather(
    table: torch.Tensor,        # (Ns, C)
    idx: torch.Tensor,          # (Nq, K) sorted-support rows
    support_xyz: torch.Tensor,  # (Ns, 3) cell-sorted at the search grid
    query_xyz: torch.Tensor,    # (Nq, 3)
    lo: torch.Tensor,
    span: torch.Tensor,
    r0: int,
    level: int,
    query_sorted: bool = True,
) -> torch.Tensor:
    """(Ns, C), (Nq, K) -> (Nq, K, C) row gather with the sorted-scatter
    backward. ``lo``/``span``/``r0``/``level`` describe the level-0 grid
    the pyramid searched on; ``query_sorted=False`` for the pool gather."""
    return SortedGather.apply(
        table, idx, support_xyz, query_xyz, lo, span, r0, level, query_sorted
    )
