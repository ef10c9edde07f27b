"""Helpers shared by the port's parity tests (tests/test_torch_*.py)."""
from __future__ import annotations

import numpy as np
import torch


def tie_aware_recall(support, query, k, idx, chunk=1024) -> float:
    """Fraction of returned neighbours whose d^2 is within the exact k-th
    d^2 (+1e-7): voxel clouds are full of distance ties, so any correct
    search may return a different member of a tie class."""
    s = torch.as_tensor(np.asarray(support), dtype=torch.float32)
    q = torch.as_tensor(np.asarray(query), dtype=torch.float32)
    idx = torch.as_tensor(np.asarray(idx)).long()
    hits = []
    for q0 in range(0, q.shape[0], chunk):
        diff = q[q0:q0 + chunk, None, :] - s[None, :, :]
        d2 = (diff * diff).sum(-1)
        kth = torch.topk(d2, k, dim=1, largest=False).values[:, -1:]
        got = d2.gather(1, idx[q0:q0 + chunk])
        hits.append((got <= kth + 1e-7).float())
    return float(torch.cat(hits).mean())


def flat_variables(variables) -> dict:
    """flax variables -> flat {"params/.../kernel": np.ndarray}."""
    from flax import traverse_util

    return {
        k: np.asarray(v)
        for k, v in traverse_util.flatten_dict(variables, sep="/").items()
    }


def to_flax_flat(model) -> dict:
    """The port's state_dict -> flat flax variables (the inverse of
    convert.convert_variables), to hand one set of weights to both sides."""
    return named_to_flax_flat(model.state_dict())


def named_to_flax_flat(named) -> dict:
    """Port tensors by state_dict name (parameters, their gradients or
    Adam moments, buffers) -> flat flax keys and layouts."""
    leaves = {"weight": "kernel", "bias": "bias",
              "running_mean": "mean", "running_var": "var"}
    flat = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        arr = t.detach().cpu().numpy()
        collection = "batch_stats" if leaf.startswith("running_") else "params"
        leaf = leaves[leaf]
        if leaf == "kernel" and arr.ndim == 1:
            leaf = "scale"                       # norm affine
        elif arr.ndim == 2:
            arr = arr.T                          # (out, in) -> (in, out)
        elif arr.ndim == 5:
            arr = arr.transpose(2, 3, 4, 1, 0)   # OIDHW -> DHWIO
        flat["/".join([collection] + path + [leaf])] = np.ascontiguousarray(arr)
    return flat


def to_torch(tree):
    """A reference NamedTuple of jax arrays (Pyramid, DeviceCloud) ->
    the port's same-named NamedTuple type of CPU tensors."""
    def conv(a):
        return torch.from_numpy(np.array(a))

    fields = [
        tuple(conv(a) for a in f) if isinstance(f, tuple) else conv(f)
        for f in tree
    ]
    return fields


def voxel_block(shape, rng) -> np.ndarray:
    """Every voxel of a ``shape`` block, shuffled, as coords / dims (the
    sampler's xyz convention)."""
    g = np.stack(
        np.meshgrid(*(np.arange(s) for s in shape), indexing="ij"), -1
    ).reshape(-1, 3)
    g = g[rng.permutation(len(g))]
    return (g / np.asarray(shape, np.float32)).astype(np.float32)
