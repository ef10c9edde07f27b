"""The port's fused path (pipeline/fused.py:FusedPointUnet) at a Pancreas
config against the reference's: 1 CT channel, 2 classes, ``num_features``
1, no ROI (the whole volume, padded to multiples of 16), a (48, 48, 32)
volume, 4,096 points, f32 models with the reference's weights converted;
and ``segment_batch_device``.

Bars, those of tests/test_torch_fused.py: attention masks agree on
>= 0.999 of voxels; with the reference's cloud and pyramid fed in, labels
agree on >= 0.999 of the sampled voxels.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.core.config import (
    pancreas_pointseg_config as jax_pcfg,
    pancreas_saliency_config as jax_scfg,
)
from pointunet_tpu.models.randlanet import init_randlanet as jax_init_pseg
from pointunet_tpu.models.saliency_unet import init_saliency_unet as jax_init_sal
from pointunet_tpu.pipeline.fused import FusedPointUnet as JaxFused
from pointunet_tpu_torch.convert import convert_saliency
from pointunet_tpu_torch.core.config import (
    pancreas_pointseg_config,
    pancreas_saliency_config,
)
from pointunet_tpu_torch.models.randlanet import init_randlanet
from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet
from pointunet_tpu_torch.ops.pyramid import Pyramid, build_pyramid_batch
from pointunet_tpu_torch.ops.sampling import DeviceCloud, sample_cloud_device
from pointunet_tpu_torch.pipeline.fused import FusedPointUnet
from torch_parity import flat_variables, to_flax_flat, to_torch

torch.set_num_threads(1)

VOLUME = (48, 48, 32)          # (X, Y, Z)
N = 4096
THRESHOLD = 0.5


@pytest.fixture(scope="module")
def ct():
    """One CT channel as ``load_pancreas_case`` gives it: a body oval of
    soft tissue (~0.41 after the HU rescale) with noise, air 0 outside,
    and a brighter organ blob."""
    rng = np.random.default_rng(0)
    xx, yy, zz = np.meshgrid(*(np.arange(s) for s in VOLUME), indexing="ij")
    body = (((xx - 24) / 22) ** 2 + ((yy - 24) / 19) ** 2) < 1
    organ = ((xx - 27) ** 2 + (yy - 21) ** 2 + (zz - 16) ** 2) < 25
    vol = 0.41 + 0.06 * rng.standard_normal(VOLUME) + 0.3 * organ
    return (np.clip(vol, 0, 1) * body).astype(np.float32)[None]


@pytest.fixture(scope="module")
def pipes(ct):
    """(reference pipe, port pipe) on one set of weights: the saliency
    net converted from the reference's; the point net the port's, with
    its head's bias centred on a cloud of this volume so that its labels
    mix both classes, handed to the reference."""
    from flax import traverse_util

    key = jax.random.PRNGKey(0)
    scfg_j, pcfg_j = jax_scfg(sa_gate_stride=2), jax_pcfg(num_points=N)
    smodel, svars = jax_init_sal(key, scfg_j)
    pmodel, _ = jax_init_pseg(key, pcfg_j, num_points=N)
    scfg = pancreas_saliency_config(sa_gate_stride=2)
    pcfg = pancreas_pointseg_config(num_points=N)
    assert (scfg.in_channels, scfg.num_class) == (1, 2)
    assert (pcfg.num_features, pcfg.num_classes) == (1, 2)
    sal = SaliencyUNet(scfg)
    sal.load_state_dict(convert_saliency(flat_variables(svars), scfg))
    pseg = init_randlanet(pcfg, torch.Generator().manual_seed(0))
    cloud = sample_cloud_device(
        torch.from_numpy(ct), torch.zeros(VOLUME, dtype=torch.uint8),
        torch.Generator().manual_seed(0), N,
    )
    pyr = build_pyramid_batch(cloud.xyz[None], pcfg.k_n, pcfg.sub_sampling_ratio)
    feats = torch.cat([cloud.xyz, cloud.features], -1)[pyr.order[0].long()]
    with torch.no_grad():
        pseg.head.bias -= pseg(feats[None], pyr)[0].mean(0)
    pvars = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in to_flax_flat(pseg).items()}, sep="/"
    )
    opts = dict(threshold=THRESHOLD, volume_shape=VOLUME)
    return (
        JaxFused(smodel, svars, pmodel, pvars, scfg_j, pcfg_j, **opts),
        FusedPointUnet(sal.eval(), pseg.eval(), scfg, pcfg, device="cpu",
                       **opts),
    )


def test_whole_volume_window(pipes):
    jpipe, tpipe = pipes
    assert tpipe.roi_shape is None and tpipe._padded == (48, 48, 32)


def test_attention_mask_agrees(pipes, ct):
    jpipe, tpipe = pipes
    want = np.asarray(jpipe._attention_mask(jnp.asarray(ct)))
    got = tpipe._attention_mask(torch.from_numpy(ct)).numpy()
    assert got.shape == want.shape == VOLUME and got.dtype == want.dtype
    assert 0 < want.sum() < np.prod(VOLUME)
    assert (got == want).mean() >= 0.999


def test_labels_with_reference_cloud(pipes, ct):
    """The reference sampler's cloud and pyramid fed in: labels of both
    classes agree on >= 0.999 of the sampled voxels."""
    jpipe, tpipe = pipes
    jm = jnp.asarray(ct)
    cloud = jpipe._sample(jm, jpipe._attention_mask(jm), jax.random.PRNGKey(3))
    jpyr = jpipe._pyramid_fn(cloud.xyz)
    want = np.asarray(jpipe._pointseg_scatter(
        jpyr, cloud.xyz, cloud.features, cloud.xyz_origin))
    tc = DeviceCloud(*to_torch(cloud))
    got = tpipe._pointseg_scatter(
        Pyramid(*to_torch(jpyr)), tc.xyz, tc.features, tc.xyz_origin
    ).numpy()
    assert got.shape == want.shape == VOLUME[::-1]
    o = np.asarray(cloud.xyz_origin)
    w, g = want[o[:, 2], o[:, 1], o[:, 0]], got[o[:, 2], o[:, 1], o[:, 0]]
    assert set(np.unique(w)) == {0, 1}
    assert (w == g).mean() >= 0.999
    assert (got == want).mean() >= 0.999


def test_segment_volume_pancreas_labels(pipes, ct):
    _, tpipe = pipes
    labels = tpipe.segment_volume(ct, seed=1, brats_labels=False)
    assert labels.shape == VOLUME and labels.dtype == np.uint8
    assert set(np.unique(labels)) == {0, 1}
    assert (labels > 0).sum() <= N


def test_segment_batch_device(pipes, ct):
    """B = 2: the same as two ``segment_device`` calls with generators of
    those seeds; a mesh that is not a ``parallel.mesh.Mesh`` raises (the
    mesh branch: tests/test_torch_parallel.py)."""
    _, tpipe = pipes
    mods = torch.from_numpy(np.stack([ct, ct[:, ::-1].copy()]))
    got = tpipe.segment_batch_device(mods, [4, 5])
    assert got.shape == (2,) + VOLUME[::-1] and got.dtype == torch.uint8
    for b, seed in enumerate((4, 5)):
        want = tpipe.segment_device(mods[b], torch.Generator().manual_seed(seed))
        assert torch.equal(got[b], want)
    assert not torch.equal(got[0], got[1])
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        tpipe.segment_batch_device(mods, [4, 5], mesh=object())
    with pytest.raises(ValueError, match="2 volumes and 1 seeds"):
        tpipe.segment_batch_device(mods, [4])
