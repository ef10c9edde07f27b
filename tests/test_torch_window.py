"""The port's host and tiling pieces of the reference-exact segment path
against the reference, on the same numpy inputs:

* ``ops/window.py``: window starts equal; ``sliding_window_inference``
  within 1e-6 (both sum f32 window predictions and divide by the cover
  count; the window model is one fixed 1x1 map and a softmax, the same
  f32 arithmetic on both sides);
* ``data/pointcloud.py``: ``volume_to_points`` and ``sample_cloud`` bit
  for bit from one seed (the same ``np.random.Generator`` calls);
* ``pipeline/postprocess.py``: equal (scipy on both sides).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.data.pointcloud import (
    sample_cloud as ref_sample_cloud,
    volume_to_points as ref_volume_to_points,
)
from pointunet_tpu.ops.window import (
    sliding_window_inference as ref_sliding,
    window_positions as ref_positions,
)
from pointunet_tpu.pipeline import postprocess as ref_post
from pointunet_tpu_torch.data.pointcloud import sample_cloud, volume_to_points
from pointunet_tpu_torch.ops.window import (
    sliding_window_inference,
    window_positions,
)
from pointunet_tpu_torch.pipeline import postprocess

torch.set_num_threads(1)


@pytest.mark.parametrize("size,patch,step", [
    (155, 64, 48), (240, 160, 118), (20, 16, 8), (10, 16, 8), (16, 16, 16),
])
def test_window_positions_match_reference(size, patch, step):
    np.testing.assert_array_equal(window_positions(size, patch, step),
                                  ref_positions(size, patch, step))


@pytest.mark.parametrize("shape,steps", [
    ((20, 40, 36), (8, 20, 12)),      # padding and overlaps on every axis
    ((16, 32, 32), (16, 32, 32)),     # one window, no padding
])
def test_sliding_window_matches_reference(shape, steps):
    rng = np.random.default_rng(0)
    c_in, n_cls, patch = 3, 2, (16, 32, 32)
    vol = rng.standard_normal(shape + (c_in,)).astype(np.float32)
    m = rng.standard_normal((c_in, n_cls)).astype(np.float32)

    def ref_model(w):                 # (1, pd, ph, pw, C) channels-last
        return jax.nn.softmax(
            jnp.einsum("bdhwc,ck->bdhwk", w, jnp.asarray(m),
                       precision=jax.lax.Precision.HIGHEST), axis=-1)

    def port_model(w):                # (1, C, pd, ph, pw) channels-first
        return torch.softmax(
            torch.einsum("bcdhw,ck->bkdhw", w, torch.from_numpy(m)), dim=1)

    want = np.asarray(ref_sliding(jnp.asarray(vol), ref_model, patch, steps,
                                  n_cls))
    got = sliding_window_inference(
        torch.from_numpy(vol).permute(3, 0, 1, 2), port_model, patch, steps,
        n_cls,
    )
    assert got.dtype == torch.float32 and got.shape == (n_cls,) + shape
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(), want,
                               atol=1e-6, rtol=1e-6)


def _volume(rng, shape=(12, 10, 8), n_mod=4):
    mods = rng.standard_normal((n_mod,) + shape).astype(np.float32)
    mods[:, :, :2] = 0.0                       # an empty slab
    labels = rng.integers(0, 4, shape).astype(np.int32)
    mask = (rng.uniform(size=shape) < 0.1).astype(np.uint8)
    return mods, labels, mask


def _assert_clouds_equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("with_labels,with_mask", [
    (False, False), (True, False), (True, True),
])
def test_volume_to_points_matches_reference(rng, with_labels, with_mask):
    mods, labels, mask = _volume(rng)
    kw = dict(labels=labels if with_labels else None,
              mask=mask if with_mask else None)
    _assert_clouds_equal(volume_to_points(mods, **kw),
                         ref_volume_to_points(mods, **kw))


@pytest.mark.parametrize("budget", [
    200,      # background fills the budget without replacement
    30,       # more foreground than the budget
    2000,     # too little background: drawn with replacement
])
def test_sample_cloud_matches_reference(rng, budget):
    mods, labels, mask = _volume(rng)
    cloud = volume_to_points(mods, labels)
    fg = mask[tuple(cloud.xyz_origin.T)]
    got = sample_cloud(cloud, budget, np.random.default_rng(7), foreground=fg)
    want = ref_sample_cloud(ref_volume_to_points(mods, labels), budget,
                            np.random.default_rng(7), foreground=fg)
    assert len(got.xyz) == budget
    _assert_clouds_equal(got, want)


def _labels(rng, shape=(24, 24, 16)):
    """A BraTS-like label volume: two tumour blobs of classes {1, 2, 4}
    with holes, a small enhancing region and scattered islands."""
    lab = np.zeros(shape, np.uint8)
    zz, yy, xx = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    ball = ((zz - 10) ** 2 + (yy - 10) ** 2 + (xx - 8) ** 2) < 36
    lab[ball] = 2
    lab[((zz - 10) ** 2 + (yy - 10) ** 2 + (xx - 8) ** 2) < 4] = 4
    lab[((zz - 18) ** 2 + (yy - 18) ** 2 + (xx - 8) ** 2) < 9] = 1
    islands = rng.uniform(size=shape) < 0.01
    lab[islands] = rng.choice(np.array([1, 2, 4], np.uint8), islands.sum())
    lab[10, 10, 11] = 0                        # a hole
    return lab


def test_postprocess_brats_matches_reference(rng):
    lab = _labels(rng)
    got = postprocess.postprocess_brats(lab)
    want = ref_post.postprocess_brats(lab)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, lab)          # the cleanup did something
    big_et = lab.copy()
    big_et[big_et > 0] = 4
    np.testing.assert_array_equal(postprocess.postprocess_brats(big_et),
                                  ref_post.postprocess_brats(big_et))


def test_postprocess_pancreas_matches_reference(rng):
    lab = (_labels(rng) > 0).astype(np.uint8)
    got = postprocess.postprocess_pancreas(lab)
    want = ref_post.postprocess_pancreas(lab)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(postprocess.fill_holes(lab),
                                  ref_post.fill_holes(lab))
    for keep in (1, 2):
        np.testing.assert_array_equal(
            postprocess.largest_components(lab, keep),
            ref_post.largest_components(lab, keep))
    empty = np.zeros((4, 4, 4), np.uint8)
    np.testing.assert_array_equal(postprocess.postprocess_pancreas(empty),
                                  ref_post.postprocess_pancreas(empty))
