"""Exact brute-force KNN (``pointunet_tpu/ops/knn.py``).

The pyramid uses it for every level of at most ``GRID_THRESHOLD`` points.
Distances use the explicit difference form, chunked over queries so the
(Q, Ns) distance block stays small; the reference's matmul expansion
exists for the TPU's matrix unit and loses precision on near ties.
"""
from __future__ import annotations

import torch

QUERY_BLOCK = 1024      # queries per (Q, Ns) distance block


def pad_k_columns(idx: torch.Tensor, k_req: int) -> torch.Tensor:
    """Widen (Nq, k_eff) neighbour indices to (Nq, k_req) by repeating the
    last column, keeping the static k-column contract when the support had
    fewer than k points."""
    k_eff = idx.shape[1]
    if k_eff >= k_req:
        return idx
    return torch.cat([idx, idx[:, -1:].expand(-1, k_req - k_eff)], dim=1)


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
    support = support.float()
    query = query.float()
    k_req, k = k, min(k, support.shape[0])
    out = []
    for q0 in range(0, query.shape[0], QUERY_BLOCK):
        q = query[q0:q0 + QUERY_BLOCK]
        diff = q[:, None, :] - support[None, :, :]          # (Q, Ns, 3)
        d2 = (diff * diff).sum(-1)
        out.append(torch.topk(d2, k, dim=1, largest=False).indices)
    if not out:
        return torch.zeros((0, k_req), torch.int32, device=query.device)
    idx = torch.cat(out).to(torch.int32)
    return pad_k_columns(idx, k_req)
