"""The last functions of the JAX package ported, each against its JAX
counterpart on the same numpy inputs: the brute-force KNN with distances
and its batch form, the gather helpers, ``grid_subsample_numpy``,
``block64_pointseg_config``, ``read_scalars``, ``prefetch_map``,
``profile_trace`` and the ``FastConv`` name.

None of them reaches a Pallas kernel in the reference (its KNN is XLA's
``top_k`` over support chunks), so the port's are plain torch.
"""
import dataclasses
import glob
import importlib
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.core import config as jax_config
from pointunet_tpu.core import metrics_sink as jax_sink
from pointunet_tpu.data import prefetch as jax_prefetch
from pointunet_tpu.ops import gather as jax_gather
from pointunet_tpu.ops import subsample as jax_subsample
from pointunet_tpu_torch.core import config, debug, metrics_sink
from pointunet_tpu_torch.data import prefetch
from pointunet_tpu_torch.models import fastconv
from pointunet_tpu_torch.ops import gather, subsample
from torch_parity import tie_aware_recall

# the modules: each package's ``ops.knn`` is its function of that name
jax_knn = importlib.import_module("pointunet_tpu.ops.knn")
knn = importlib.import_module("pointunet_tpu_torch.ops.knn")

torch.set_num_threads(1)


def _voxels(rng, n, side=12):
    """``n`` distinct voxel centres of a side^3 grid: full of distance
    ties, as the pipeline's clouds are."""
    g = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1)
    g = g.reshape(-1, 3)[rng.permutation(side ** 3)[:n]]
    return (g / side).astype(np.float32)


@pytest.mark.parametrize("ns,nq,k", [
    (400, 150, 16),       # Ns >> k
    (5, 40, 16),          # Ns < k: both outputs padded
    (300, 1, 1),
])
def test_knn_with_distances_matches_reference(rng, ns, nq, k):
    support, query = _voxels(rng, ns), _voxels(rng, nq)
    ref_idx, ref_d2 = map(np.asarray, jax_knn.knn_with_distances(
        jnp.asarray(support), jnp.asarray(query), k))
    idx, d2 = knn.knn_with_distances(
        torch.from_numpy(support), torch.from_numpy(query), k)
    assert idx.dtype == torch.int32 and d2.dtype == torch.float32
    assert idx.shape == d2.shape == ref_idx.shape == (nq, k)
    idx, d2 = idx.numpy(), d2.numpy()
    k_eff = min(k, ns)
    assert tie_aware_recall(support, query, k_eff, idx[:, :k_eff]) == 1.0
    # nearest first, each d^2 the exact difference form of its index
    assert (np.diff(d2, axis=1) >= 0).all()
    exact = ((query[:, None, :] - support[idx]) ** 2).sum(-1)
    np.testing.assert_array_equal(d2, exact)
    # the reference's expansion reads ties and self-matches a little off
    np.testing.assert_allclose(d2, ref_d2, rtol=0, atol=1e-5)
    # padding repeats the last valid column in both outputs
    for out in (idx, d2):
        np.testing.assert_array_equal(
            out[:, k_eff:], np.repeat(out[:, k_eff - 1:k_eff], k - k_eff, 1))
    # the index-only entry point returns the same rows
    np.testing.assert_array_equal(
        knn.knn(torch.from_numpy(support), torch.from_numpy(query), k).numpy(),
        idx)


def test_knn_query_block_stays_in_its_budget():
    assert knn.query_block(16_384) == knn.QUERY_BLOCK
    for ns in (10 ** 5, 365_000, 10 ** 7):
        q = knn.query_block(ns)
        assert 1 <= q < knn.QUERY_BLOCK
        assert q * ns * 12 <= knn.BLOCK_BYTES
    assert knn.query_block(10 ** 9) == 1


def test_knn_blocks_give_the_rows_of_one_block(rng, monkeypatch):
    support, query = _voxels(rng, 500), _voxels(rng, 300)
    s, q = torch.from_numpy(support), torch.from_numpy(query)
    whole = knn.knn_with_distances(s, q, 8)
    monkeypatch.setattr(knn, "BLOCK_BYTES", 12 * 500 * 7)   # 7 queries a block
    assert knn.query_block(500) == 7
    for a, b in zip(whole, knn.knn_with_distances(s, q, 8)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_knn_batch_matches_reference(rng):
    support = np.stack([_voxels(rng, 350) for _ in range(2)])
    query = np.stack([_voxels(rng, 120) for _ in range(2)])
    ref = np.asarray(jax_knn.knn_batch(
        jnp.asarray(support), jnp.asarray(query), 16))
    got = knn.knn_batch(torch.from_numpy(support), torch.from_numpy(query), 16)
    assert got.dtype == torch.int32 and got.shape == ref.shape == (2, 120, 16)
    got = got.numpy()
    for b in range(2):
        assert tie_aware_recall(support[b], query[b], 16, got[b]) == 1.0
        d2 = ((query[b][:, None] - support[b][got[b]]) ** 2).sum(-1)
        d2_ref = ((query[b][:, None] - support[b][ref[b]]) ** 2).sum(-1)
        np.testing.assert_allclose(np.sort(d2, 1), np.sort(d2_ref, 1),
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            got[b], knn.knn(torch.from_numpy(support[b]),
                            torch.from_numpy(query[b]), 16).numpy())


@pytest.mark.parametrize("name,idx_shape", [
    ("max_pool_neighbours", (30, 6)),
    ("nearest_interpolation", (45,)),
    ("nearest_interpolation", (45, 1)),
    ("relative_pos_encoding", (40, 6)),
])
def test_gather_helpers_match_reference(rng, name, idx_shape):
    """Forward and gradient of each helper against the reference's (the
    gradient of sum(out * w) by jax.grad and by autograd)."""
    d = 3 if name == "relative_pos_encoding" else 5
    feats = rng.standard_normal((40, d)).astype(np.float32)
    idx = rng.integers(0, 40, idx_shape).astype(np.int32)
    ref_fn, fn = getattr(jax_gather, name), getattr(gather, name)
    ref = np.asarray(ref_fn(jnp.asarray(feats), jnp.asarray(idx)))
    x = torch.from_numpy(feats).requires_grad_(True)
    out = fn(x, torch.from_numpy(idx))
    assert out.shape == ref.shape
    w = rng.standard_normal(ref.shape).astype(np.float32)
    ref_grad = np.asarray(jax.grad(
        lambda f: jnp.sum(ref_fn(f, jnp.asarray(idx)) * w))(jnp.asarray(feats)))
    (out * torch.from_numpy(w)).sum().backward()
    if name == "relative_pos_encoding":
        np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                                   atol=1e-6)
        np.testing.assert_allclose(x.grad.numpy(), ref_grad, rtol=1e-5,
                                   atol=1e-5)
    else:
        np.testing.assert_array_equal(out.detach().numpy(), ref)
        np.testing.assert_allclose(x.grad.numpy(), ref_grad, rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("with_features,with_labels", [
    (False, False), (True, False), (False, True), (True, True),
])
def test_grid_subsample_numpy_bit_equal(rng, with_features, with_labels):
    points = rng.uniform(0, 1, (3000, 3)).astype(np.float32)
    feats = rng.standard_normal((3000, 4)).astype(np.float32)
    labels = rng.integers(0, 4, 3000).astype(np.int32)
    args = (points, feats if with_features else None,
            labels if with_labels else None, 0.07)
    ref = jax_subsample.grid_subsample_numpy(*args)
    for got in (subsample.grid_subsample_numpy(*args),
                subsample.grid_subsample(*args)):
        ref_t = ref if isinstance(ref, tuple) else (ref,)
        got_t = got if isinstance(got, tuple) else (got,)
        assert len(got_t) == len(ref_t) == 1 + with_features + with_labels
        for a, b in zip(got_t, ref_t):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("overrides", [{}, {"use_bfloat16": True,
                                            "num_points": 4096}])
def test_block64_pointseg_config(overrides):
    ref = jax_config.block64_pointseg_config(**overrides)
    got = config.block64_pointseg_config(**overrides)
    assert got.name == "BraTS_Block64" and got.num_points == ref.num_points
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.class_weights() == ref.class_weights()
    assert got.level_sizes == ref.level_sizes


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_read_scalars(tmp_path, writer):
    logger = {"jax": jax_sink, "port": metrics_sink}[writer].MetricsLogger
    with logger(str(tmp_path)) as sink:
        sink.log(1, loss=2.5, lr=1e-4)
        sink.log(2, loss=np.float32(1.25), grad_norm=float("inf"))
        path = sink.path
    with open(path, "a") as f:
        f.write("\n   \n")
    with logger(str(tmp_path)) as sink:
        sink.log(3, loss=float("nan"))
    rows = metrics_sink.read_scalars(path)
    assert rows == jax_sink.read_scalars(path)
    assert [r["step"] for r in rows] == [1, 2, 3]
    assert rows[0]["loss"] == 2.5 and rows[1]["grad_norm"] == "inf"
    assert rows[2]["loss"] == "nan"


class _Counted:
    """An iterable that counts the items taken from it."""

    def __init__(self, n):
        self.n, self.taken = n, 0

    def __iter__(self):
        for i in range(self.n):
            self.taken += 1
            yield i


def _trace(prefetch_map, n, buffer_size, fail_at=None):
    """[(item, items taken when it reached the consumer)], and the
    exception raised, if any."""
    items = _Counted(n)
    lock = threading.Lock()

    def fn(x):
        if x == fail_at:
            raise KeyError(x)
        with lock:
            return x * x

    out = []
    try:
        for y in prefetch_map(fn, items, num_threads=3,
                              buffer_size=buffer_size):
            out.append((y, items.taken))
    except KeyError as e:
        return out, e.args
    return out, None


@pytest.mark.parametrize("n,buffer_size,fail_at", [
    (20, 4, None), (3, 4, None), (12, 1, None), (10, 4, 6), (10, 2, 0),
])
def test_prefetch_map_order_lookahead_and_errors(n, buffer_size, fail_at):
    got = _trace(prefetch.prefetch_map, n, buffer_size, fail_at)
    assert got == _trace(jax_prefetch.prefetch_map, n, buffer_size, fail_at)
    out, err = got
    stop = n if fail_at is None else fail_at
    assert [y for y, _ in out] == [x * x for x in range(stop)]
    # item i reaches the consumer with at most buffer_size items taken
    # beyond those already consumed
    assert all(taken <= min(n, i + buffer_size)
               for i, (_, taken) in enumerate(out))
    assert err == (None if fail_at is None else (fail_at,))


def test_prefetch_map_without_a_buffer_maps_every_item():
    """The reference's map yields nothing at buffer_size 0; the port's
    runs one item ahead."""
    assert list(jax_prefetch.prefetch_map(abs, [-1, -2], buffer_size=0)) == []
    out, _ = _trace(prefetch.prefetch_map, 5, 0)
    assert out == [(x * x, min(5, x + 1)) for x in range(5)]


def test_profile_trace_writes_a_trace(tmp_path, monkeypatch):
    logdir = str(tmp_path / "trace")
    with debug.profile_trace(logdir, device="cpu"):
        torch.ones(64, 64).matmul(torch.ones(64, 64)).sum()
    files = glob.glob(os.path.join(logdir, "*.pt.trace.json"))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") for e in events)
    # on the card's default it never records the host alone instead
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        with debug.profile_trace(str(tmp_path / "cuda")):
            pass
    with pytest.raises(ValueError, match="not cuda or cpu"):
        with debug.profile_trace(str(tmp_path / "tpu"), device="tpu"):
            pass


def test_fastconv_is_conv():
    import pointunet_tpu_torch.models as models

    assert fastconv.FastConv is fastconv.Conv is models.FastConv
