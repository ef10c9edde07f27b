"""The port's fused slice (pointunet_tpu_torch/pipeline/fused.py) against the
reference's ``FusedPointUnet``, on a small synthetic volume: (4, 48, 48,
32), ROI (32, 32, 32), 4,096 points, f32 models with the reference's
weights converted.

Torch cannot reproduce ``jax.random``, so the label comparisons feed the
port the reference sampler's cloud; the port's sampler is checked by its
invariants instead. Bars: attention masks agree on >= 0.999 of voxels
(flips only where a probability sits at the threshold). With weights
that yield several classes, labels agree on >= 0.999 of the sampled
voxels with the reference's pyramid fed in; with each side's own
pyramid, whose neighbour rows differ only within distance tie classes,
on >= 0.993 of voxels (measured). The scatter is bit for bit.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.core.config import (
    brats_pointseg_config as jax_pcfg,
    brats_saliency_config as jax_scfg,
)
from pointunet_tpu.models.randlanet import init_randlanet as jax_init_pseg
from pointunet_tpu.models.saliency_unet import init_saliency_unet as jax_init_sal
from pointunet_tpu.ops.scatter import (
    scatter_labels_to_volume as jax_scatter_labels,
    scatter_probs_to_volume as jax_scatter_probs,
)
from pointunet_tpu.pipeline.fused import FusedPointUnet as JaxFused
from pointunet_tpu_torch.convert import convert_randlanet, convert_saliency
from pointunet_tpu_torch.core.config import (
    brats_pointseg_config,
    brats_saliency_config,
)
from pointunet_tpu_torch.models.randlanet import RandLANet, init_randlanet
from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet
from pointunet_tpu_torch.ops.pyramid import Pyramid, build_pyramid_batch
from pointunet_tpu_torch.ops.sampling import DeviceCloud, sample_cloud_device
from pointunet_tpu_torch.ops.scatter import (
    scatter_labels_to_volume,
    scatter_probs_to_volume,
)
from pointunet_tpu_torch.pipeline.fused import FusedPointUnet
from torch_parity import flat_variables, to_flax_flat, to_torch

torch.set_num_threads(1)

VOLUME = (48, 48, 32)          # (X, Y, Z)
ROI = (32, 32, 32)
N = 4096
THRESHOLD = 0.5
CASES = {
    "plain": {},
    "downscale_band": {"att_downscale": 2, "mask_band": 4},
    "dilate": {"mask_dilate": 2},
}


@pytest.fixture(scope="module")
def models():
    key = jax.random.PRNGKey(0)
    scfg_j = jax_scfg(sa_gate_stride=2)
    pcfg_j = jax_pcfg(num_points=N)
    smodel, svars = jax_init_sal(key, scfg_j)
    pmodel, pvars = jax_init_pseg(key, pcfg_j, num_points=N)
    scfg = brats_saliency_config(sa_gate_stride=2)
    pcfg = brats_pointseg_config(num_points=N)
    sal = SaliencyUNet(scfg)
    sal.load_state_dict(convert_saliency(flat_variables(svars), scfg))
    pseg = RandLANet(pcfg)
    pseg.load_state_dict(convert_randlanet(flat_variables(pvars), pcfg))
    return {
        "jax": (smodel, svars, pmodel, pvars, scfg_j, pcfg_j),
        "port": (sal.eval(), pseg.eval(), scfg, pcfg),
    }


@pytest.fixture(scope="module")
def mods():
    """Four noisy modalities in an off-centre ellipsoid brain, with a
    bright blob; exact zeros outside the brain."""
    rng = np.random.default_rng(0)
    xx, yy, zz = np.meshgrid(*(np.arange(s) for s in VOLUME), indexing="ij")
    brain = (((xx - 26) / 18) ** 2 + ((yy - 22) / 17) ** 2
             + ((zz - 15) / 13) ** 2) < 1
    blob = ((xx - 30) ** 2 + (yy - 20) ** 2 + (zz - 16) ** 2) < 36
    vol = rng.standard_normal((4,) + VOLUME).astype(np.float32) + 3.0 * blob
    return (vol * brain).astype(np.float32)


@pytest.fixture(scope="module", params=list(CASES))
def pipes(request, models):
    opts = dict(threshold=THRESHOLD, volume_shape=VOLUME, roi_shape=ROI,
                **CASES[request.param])
    return (
        JaxFused(*models["jax"], **opts),
        FusedPointUnet(*models["port"], device="cpu", **opts),
    )


def test_attention_mask_agrees(pipes, mods):
    jpipe, tpipe = pipes
    want = np.asarray(jpipe._attention_mask(jnp.asarray(mods)))
    got = tpipe._attention_mask(torch.from_numpy(mods)).numpy()
    assert got.shape == want.shape == VOLUME
    assert got.dtype == want.dtype
    # a mask with nothing or everything salient would test nothing
    core = want == 2 if want.dtype == np.uint8 else want
    assert 0 < core.sum() < np.prod(ROI)
    assert (got == want).mean() >= 0.999


@pytest.fixture(scope="module")
def mixed(models, mods):
    """Both point nets with one set of weights whose labels mix several
    classes: (reference pipe, port pipe), without the attention options
    (the stage does not read them)."""
    from flax import traverse_util

    smodel, svars, pmodel, _, scfg_j, pcfg_j = models["jax"]
    sal, _, scfg, pcfg = models["port"]
    pseg = init_randlanet(pcfg, torch.Generator().manual_seed(0))
    # random weights put a large common offset on each class's logit, so
    # one class wins everywhere; centring the head's bias on a cloud of
    # this volume leaves the point-dependent part to pick the class
    cloud = sample_cloud_device(
        torch.from_numpy(mods), torch.zeros(VOLUME, dtype=torch.uint8),
        torch.Generator().manual_seed(0), N,
    )
    pyr = build_pyramid_batch(cloud.xyz[None], pcfg.k_n, pcfg.sub_sampling_ratio)
    feats = torch.cat([cloud.xyz, cloud.features], -1)[pyr.order[0].long()]
    with torch.no_grad():
        pseg.head.bias -= pseg(feats[None], pyr)[0].mean(0)
    pvars = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in to_flax_flat(pseg).items()}, sep="/"
    )
    opts = dict(threshold=THRESHOLD, volume_shape=VOLUME, roi_shape=ROI)
    return (
        JaxFused(smodel, svars, pmodel, pvars, scfg_j, pcfg_j, **opts),
        FusedPointUnet(sal, pseg, scfg, pcfg, device="cpu", **opts),
    )


def _tie_swaps(support, query, got, want):
    """(rows where ``got`` and ``want`` differ, of those the rows whose
    chosen neighbours differ in distance): both are (Q, k) rows into
    ``support``; each row's squared distances are computed in f64 and
    sorted, so two rows that pick different members of one tie class
    compare equal. Voxel coordinates divided by the volume's extent are
    rounded to f32, so the members of a tie class differ in d^2 by
    ~1e-8, while distinct distance shells of this volume differ by at
    least 1/9216 ~ 1.1e-4: 1e-6 tells the two apart."""
    s = np.asarray(support, np.float64)
    q = np.asarray(query, np.float64)[:, None, :]
    got, want = np.asarray(got), np.asarray(want)
    d_got = np.sort(((q - s[got]) ** 2).sum(-1), 1)
    d_want = np.sort(((q - s[want]) ** 2).sum(-1), 1)
    differ = (got != want).any(1)
    off = (np.abs(d_got - d_want) > 1e-6).any(1)
    return int(differ.sum()), int(off.sum())


def test_labels_with_reference_cloud(pipes, mixed, mods):
    """The reference sampler's cloud fed in, each side its own pyramid,
    weights whose labels mix several classes. The pyramids' bookkeeping
    is bit-equal, and their neighbour rows differ only in which member of
    a distance tie class they pick: the reference's exact KNN picks by the
    rounding of its matmul expansion, the port's by the difference
    form's d^2 and then the lower row. Those swaps change the near-tied logits of these
    random weights, so labels agree on fewer voxels than with the
    reference's pyramid fed in (next test): measured 0.998711, 0.995158
    and 0.998752 of voxels for the plain, downscale_band and dilate
    cases, so the bar is 0.993."""
    jm = jnp.asarray(mods)
    jpipe = pipes[0]
    cloud = jpipe._sample(jm, jpipe._attention_mask(jm), jax.random.PRNGKey(3))
    mj, mt = mixed
    jpyr = mj._pyramid_fn(cloud.xyz)
    want = np.asarray(mj._pointseg_scatter(
        jpyr, cloud.xyz, cloud.features, cloud.xyz_origin
    ))
    tc = DeviceCloud(*to_torch(cloud))
    pyr = mt._pyramid_fn(tc.xyz)
    ref = Pyramid(*to_torch(jpyr))
    np.testing.assert_array_equal(pyr.order.numpy(), ref.order.numpy())
    swaps = 0
    for i in range(len(pyr.neigh_idx)):
        x, sub = ref.xyz[i][0].numpy(), ref.xyz[i + 1][0].numpy()
        np.testing.assert_array_equal(pyr.xyz[i][0].numpy(), x)
        np.testing.assert_array_equal(pyr.xyz[i + 1][0].numpy(), sub)
        for q, s_, a, b in (
            (x, x, pyr.neigh_idx[i], ref.neigh_idx[i]),
            (sub, x, pyr.sub_idx[i], ref.sub_idx[i]),
            (x, sub, pyr.interp_idx[i], ref.interp_idx[i]),
        ):
            differ, off = _tie_swaps(s_, q, a[0].long(), b[0].long())
            assert off == 0, (i, differ, off)
            swaps += differ
    assert swaps > 0          # the voxel cloud is full of ties

    got = mt._pointseg_scatter(
        pyr, tc.xyz, tc.features, tc.xyz_origin
    ).numpy()
    assert got.shape == want.shape == VOLUME[::-1]
    assert got.dtype == want.dtype == np.uint8
    o = np.asarray(cloud.xyz_origin)
    assert len(np.unique(want[o[:, 2], o[:, 1], o[:, 0]])) >= 2
    assert (got == want).mean() >= 0.993


def test_pointseg_scatter_with_reference_pyramid(pipes, mixed, mods):
    """The point net, argmax and scatter alone: with the reference's
    cloud AND pyramid fed in, labels of several classes agree on
    >= 0.999 of the sampled voxels. (With each side's own pyramid the
    exact KNNs break distance ties differently, which flips up to ~9 % of
    the sampled points on these near-tied random logits: the previous
    test.)"""
    jm = jnp.asarray(mods)
    jpipe = pipes[0]
    cloud = jpipe._sample(jm, jpipe._attention_mask(jm), jax.random.PRNGKey(3))
    mj, mt = mixed
    jpyr = mj._pyramid_fn(cloud.xyz)
    want = np.asarray(mj._pointseg_scatter(
        jpyr, cloud.xyz, cloud.features, cloud.xyz_origin
    ))
    tc = DeviceCloud(*to_torch(cloud))
    got = mt._pointseg_scatter(
        Pyramid(*to_torch(jpyr)), tc.xyz, tc.features, tc.xyz_origin
    ).numpy()
    o = np.asarray(cloud.xyz_origin)
    w, g = want[o[:, 2], o[:, 1], o[:, 0]], got[o[:, 2], o[:, 1], o[:, 0]]
    assert len(np.unique(w)) >= 2
    assert (w == g).mean() >= 0.999
    assert (got == want).mean() >= 0.999


def test_scatter_bit_exact(rng):
    shape = (6, 7, 8)                                  # (Z, Y, X)
    flat = rng.choice(np.prod(shape), 100, replace=False)
    z, y, x = np.unravel_index(flat, shape)
    xyz = np.stack([x, y, z], -1).astype(np.int32)
    labels = rng.integers(0, 4, 100).astype(np.uint8)
    probs = rng.uniform(size=(100, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        scatter_labels_to_volume(
            torch.from_numpy(labels), torch.from_numpy(xyz), shape
        ).numpy(),
        np.asarray(jax_scatter_labels(jnp.asarray(labels), jnp.asarray(xyz), shape)),
    )
    np.testing.assert_array_equal(
        scatter_probs_to_volume(
            torch.from_numpy(probs), torch.from_numpy(xyz), shape
        ).numpy(),
        np.asarray(jax_scatter_probs(jnp.asarray(probs), jnp.asarray(xyz), shape)),
    )


def _sample(mods, mask, n, seed=0):
    return sample_cloud_device(
        torch.from_numpy(mods), torch.from_numpy(mask),
        torch.Generator().manual_seed(seed), n,
    )


def test_sampler_invariants(rng):
    mods = np.zeros((2, 16, 16, 8), np.float32)
    mods[:, 2:14, 2:14, 1:7] = rng.uniform(0.5, 1.5, (12, 12, 6))
    mask = np.zeros((16, 16, 8), np.uint8)
    mask[6:10, 6:10, 3:5] = 1
    cloud = _sample(mods, mask, 256)
    o = cloud.xyz_origin.numpy()
    assert len(np.unique(o, axis=0)) == 256                # no repeats
    assert mask[o[:, 0], o[:, 1], o[:, 2]].sum() == mask.sum()
    assert (mods != 0).any(0)[o[:, 0], o[:, 1], o[:, 2]].all()
    np.testing.assert_allclose(cloud.xyz.numpy(), o / np.array([16, 16, 8]))
    np.testing.assert_array_equal(
        cloud.features.numpy(), mods[:, o[:, 0], o[:, 1], o[:, 2]].T
    )
    # shuffled: salient voxels are spread through the order, not first
    sal = mask[o[:, 0], o[:, 1], o[:, 2]].astype(bool)
    assert sal[:32].sum() < 32


def test_sampler_graded_tiers():
    mods = np.ones((1, 16, 16, 8), np.float32)
    mods[:, 14:] = 0                                       # empty voxels
    mask = np.zeros((16, 16, 8), np.uint8)
    mask[2:10, 2:10, 2:6] = 2                              # 256 core
    mask[10:14, 2:10, 2:6] = 1                             # 128 band
    o = _sample(mods, mask, 320).xyz_origin.numpy()
    tiers = mask[o[:, 0], o[:, 1], o[:, 2]]
    assert (tiers == 2).sum() == 256 and (tiers == 1).sum() == 64
    o = _sample(mods, mask, 512, seed=1).xyz_origin.numpy()
    tiers = mask[o[:, 0], o[:, 1], o[:, 2]]
    assert (tiers == 2).sum() == 256 and (tiers == 1).sum() == 128
    assert (mods[0][o[:, 0], o[:, 1], o[:, 2]] != 0).all()
    # more budget than non-empty voxels: the rest are empty ones
    o = _sample(mods, mask, 16 * 16 * 8 - 8, seed=2).xyz_origin.numpy()
    assert (mods[0][o[:, 0], o[:, 1], o[:, 2]] != 0).sum() == 14 * 16 * 8


def test_segment_volume(models, mods):
    pipe = FusedPointUnet(
        *models["port"], threshold=THRESHOLD, volume_shape=VOLUME,
        roi_shape=ROI, device="cpu",
    )
    labels = pipe.segment_volume(mods, seed=1)
    assert labels.shape == VOLUME
    assert set(np.unique(labels)) <= {0, 1, 2, 4}
    assert 0 < (labels > 0).sum() <= N
    np.testing.assert_array_equal(labels, pipe.segment_volume(mods, seed=1))


def test_band_threshold_mask_agrees(models, mods):
    """A non-default ``band_threshold``: the port's graded mask equals the
    reference's on the same converted weights and volume (the bar of
    test_attention_mask_agrees), and it differs from the default's."""
    opts = dict(threshold=THRESHOLD, volume_shape=VOLUME, roi_shape=ROI,
                **CASES["downscale_band"])
    want = np.asarray(JaxFused(*models["jax"], band_threshold=0.3, **opts)
                      ._attention_mask(jnp.asarray(mods)))
    got = FusedPointUnet(*models["port"], band_threshold=0.3, device="cpu",
                         **opts)._attention_mask(torch.from_numpy(mods)).numpy()
    default = FusedPointUnet(*models["port"], device="cpu", **opts)
    assert default.band_threshold == THRESHOLD / 4
    assert got.dtype == want.dtype == np.uint8
    assert (got == want).mean() >= 0.999
    assert (got == 1).sum() < (default._attention_mask(
        torch.from_numpy(mods)).numpy() == 1).sum()


def test_segment_volume_brats_labels(models, mods):
    """At the 4-class BraTS config, class 3 comes out as 4 only with
    ``brats_labels`` (the default); a head biased to class 3 puts it on
    every sampled voxel."""
    sal, pseg, scfg, pcfg = models["port"]
    pseg = copy.deepcopy(pseg)
    with torch.no_grad():
        pseg.head.bias[3] += 1e4
    pipe = FusedPointUnet(sal, pseg, scfg, pcfg, threshold=THRESHOLD,
                          volume_shape=VOLUME, roi_shape=ROI, device="cpu")
    raw = pipe.segment_volume(mods, seed=1, brats_labels=False)
    assert pcfg.num_classes == 4
    assert set(np.unique(raw)) == {0, 3}
    np.testing.assert_array_equal(pipe.segment_volume(mods, seed=1),
                                  np.where(raw == 3, 4, raw))


def test_fused_rejects_conflicting_modes(models):
    with pytest.raises(ValueError, match="mutually exclusive"):
        FusedPointUnet(*models["port"], mask_band=2, mask_dilate=1,
                       device="cpu")
    with pytest.raises(ValueError, match="att_downscale"):
        FusedPointUnet(*models["port"], att_downscale=0, device="cpu")
