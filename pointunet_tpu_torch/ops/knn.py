"""Exact brute-force KNN (``pointunet_tpu/ops/knn.py``).

The pyramid uses it for every level of at most ``GRID_THRESHOLD`` points.
Distances use the explicit difference form, chunked over queries so the
(Q, Ns, 3) difference block stays within ``BLOCK_BYTES``; the reference's
matmul expansion (2 q.s - |q|^2 - |s|^2) exists for the TPU's matrix unit,
loses precision on near ties and can read a self-match's d^2 slightly
below 0, where the difference form gives exactly 0.
"""
from __future__ import annotations

import torch

QUERY_BLOCK = 1024      # most queries per (Q, Ns) distance block
BLOCK_BYTES = 1 << 28   # most bytes of a block's (Q, Ns, 3) f32 differences


def pad_k_columns(idx: torch.Tensor, k_req: int) -> torch.Tensor:
    """Widen (Nq, k_eff) neighbour indices to (Nq, k_req) by repeating the
    last column, keeping the static k-column contract when the support had
    fewer than k points."""
    k_eff = idx.shape[1]
    if k_eff >= k_req:
        return idx
    return torch.cat([idx, idx[:, -1:].expand(-1, k_req - k_eff)], dim=1)


def query_block(ns: int) -> int:
    """Queries a distance block: ``QUERY_BLOCK``, fewer where the support
    is large enough that the block's differences would pass
    ``BLOCK_BYTES``, at least 1."""
    return max(1, min(QUERY_BLOCK, BLOCK_BYTES // (12 * max(ns, 1))))


def _search(support: torch.Tensor, query: torch.Tensor, k: int):
    """(d^2 (Nq, k_eff) f32, idx (Nq, k_eff) int32), nearest first,
    k_eff = min(k, Ns), on the inputs' device."""
    support = support.float()
    query = query.float()
    k = min(k, support.shape[0])
    block = query_block(support.shape[0])
    d2s, idxs = [], []
    for q0 in range(0, query.shape[0], block):
        q = query[q0:q0 + block]
        diff = q[:, None, :] - support[None, :, :]          # (Q, Ns, 3)
        best = torch.topk((diff * diff).sum(-1), k, dim=1, largest=False)
        d2s.append(best.values)
        idxs.append(best.indices.to(torch.int32))
    if not idxs:
        empty = torch.zeros((0, k), device=query.device)
        return empty, empty.to(torch.int32)
    return torch.cat(d2s), torch.cat(idxs)


def knn(
    support: torch.Tensor,       # (Ns, 3)
    query: torch.Tensor,         # (Nq, 3)
    k: int,
) -> torch.Tensor:
    """Exact KNN: (Nq, k) int32 indices into ``support``, nearest first.

    When the support has fewer than k points the trailing columns repeat
    the last neighbour (``pad_k_columns``). Argument order (support first)
    matches the reference.
    """
    return pad_k_columns(_search(support, query, k)[1], k)


def knn_with_distances(
    support: torch.Tensor,       # (Ns, 3)
    query: torch.Tensor,         # (Nq, 3)
    k: int,
) -> tuple:
    """As ``knn``, with the squared distances: (idx (Nq, k) int32, d^2
    (Nq, k) f32), nearest first; when Ns < k the trailing columns of both
    repeat the last neighbour."""
    d2, idx = _search(support, query, k)
    return pad_k_columns(idx, k), pad_k_columns(d2, k)


def knn_batch(
    support: torch.Tensor,       # (B, Ns, 3)
    query: torch.Tensor,         # (B, Nq, 3)
    k: int,
) -> torch.Tensor:
    """``knn`` of each cloud of a batch: (B, Nq, k) int32."""
    return torch.stack([knn(s, q, k) for s, q in zip(support, query)])
