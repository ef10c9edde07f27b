"""The port's reference-exact segment path (pointunet_tpu_torch/pipeline/
end2end.py, cli/segment.py) against the reference's ``PointUnetPipeline``,
on tests/util_synthetic.py's small BraTS case (X, Y, Z) = (32, 32, 20),
with the full-width nets and converted weights, f32, the spatial-attention
gate at stride 1, the attention window cut to (16, 32, 32) with steps
(8, 16, 16) (two overlapping windows along Z), and 4,096 points.

Bars:

* ``attention_map``: atol 3e-4, rtol 1e-4, the saliency logits' bar
  (tests/test_torch_saliency.py; softmax shrinks differences), with the
  convs on ``F.conv3d`` and on kernel 3's route (its plain version here);
* the sampled cloud: equal (the same ``np.random.Generator`` calls);
* labels with the reference's binary map passed in and point-net weights
  whose labels mix several classes: equal on >= 0.993 of the volume's
  voxels, the bar of tests/test_torch_fused.py for each side's own
  pyramid (the exact KNNs break distance ties differently, which flips
  near-tied random logits: measured 0.9797 of the sampled voxels).

Also: the ``segment`` CLI on the CPU (default path, ``--postprocess``,
``--fast``), its checkpoint flags, and the entry points' device default:
the card, so that a host without one fails instead of running on the CPU.
"""
import argparse
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pointunet_tpu.core.config import (
    brats_pointseg_config as jax_pcfg,
    brats_saliency_config as jax_scfg,
)
from pointunet_tpu.data.pointcloud import (
    sample_cloud as ref_sample_cloud,
    volume_to_points as ref_volume_to_points,
)
from pointunet_tpu.models.randlanet import init_randlanet as jax_init_pseg
from pointunet_tpu.models.saliency_unet import init_saliency_unet as jax_init_sal
from pointunet_tpu.pipeline.end2end import PointUnetPipeline as JaxPipeline
from pointunet_tpu_torch.cli import segment
from pointunet_tpu_torch.convert import convert_randlanet, convert_saliency
from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
from pointunet_tpu_torch.core.config import (
    brats_pointseg_config,
    brats_saliency_config,
)
from pointunet_tpu_torch.data import nifti
from pointunet_tpu_torch.data.loader import load_brats_volume
from pointunet_tpu_torch.data.pointcloud import sample_cloud, volume_to_points
from pointunet_tpu_torch.models.randlanet import RandLANet
from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet
from pointunet_tpu_torch.ops.pyramid import build_pyramid_batch
from pointunet_tpu_torch.pipeline.end2end import PointUnetPipeline
from pointunet_tpu_torch.pipeline.fused import FusedPointUnet
from pointunet_tpu_torch.train.pointseg import PointSegTrainer
from torch_parity import flat_variables, to_flax_flat
from util_synthetic import make_brats_case

torch.set_num_threads(1)

N = 4096
THRESHOLD = 0.5
PATCH = dict(inference_patch_size=(16, 32, 32), xstep=8, ystep=16, zstep=16)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("cases"))
    _, seg = make_brats_case(root, "case_a")
    return root, load_brats_volume(os.path.join(root, "case_a")), seg


@pytest.fixture(scope="module")
def models(case):
    """Reference and port models with one set of weights. The point net's
    head bias is centred on a cloud of this case, so that its labels mix
    several classes (random weights put one large offset on each class's
    logit)."""
    key = jax.random.PRNGKey(0)
    scfg_j = jax_scfg(sa_gate_stride=1, **PATCH)
    pcfg_j = jax_pcfg(num_points=N)
    smodel, svars = jax_init_sal(key, scfg_j)
    pmodel, pvars = jax_init_pseg(key, pcfg_j, num_points=N)
    scfg = brats_saliency_config(sa_gate_stride=1, **PATCH)
    pcfg = brats_pointseg_config(num_points=N)
    sal = SaliencyUNet(scfg)
    sal.load_state_dict(convert_saliency(flat_variables(svars), scfg))
    pseg = RandLANet(pcfg)
    pseg.load_state_dict(convert_randlanet(flat_variables(pvars), pcfg))
    pseg.eval()
    cloud = sample_cloud(volume_to_points(case[1]), N,
                         np.random.default_rng(1))
    xyz = torch.from_numpy(cloud.xyz)
    pyr = build_pyramid_batch(xyz[None], pcfg.k_n, pcfg.sub_sampling_ratio)
    feats = torch.cat([xyz, torch.from_numpy(cloud.features)], -1)
    with torch.no_grad():
        pseg.head.bias -= pseg(feats[pyr.order[0].long()][None], pyr)[0].mean(0)
    pvars = traverse_util.unflatten_dict(
        {k: jnp.asarray(v) for k, v in to_flax_flat(pseg).items()}, sep="/")
    return {
        "jax": (smodel, svars, pmodel, pvars, scfg_j, pcfg_j),
        "port": (sal.eval(), pseg, scfg, pcfg),
    }


def _pipes(models):
    """A fresh pair (reference, port): both samplers at seed 0."""
    return (
        JaxPipeline(*models["jax"], threshold=THRESHOLD, seed=0),
        PointUnetPipeline(*models["port"], threshold=THRESHOLD, seed=0,
                          device="cpu"),
    )


@pytest.mark.parametrize("route", ["", "pallas"])
def test_attention_map_matches_reference(models, case, monkeypatch, route):
    jpipe, tpipe = _pipes(models)
    mods = case[1]
    want = jpipe.attention_map(mods)
    monkeypatch.setenv("POINTUNET_FASTCONV", route)   # the port's forward only
    got = tpipe.attention_map(mods)
    assert got.shape == want.shape == mods.shape[1:]
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=3e-4, rtol=1e-4)
    # a map with nothing or everything above threshold would test little
    assert 0 < (want >= THRESHOLD).sum() < want.size


def test_sampled_cloud_equals_reference(models, case):
    _, tpipe = _pipes(models)
    mods = case[1]
    mask = (np.random.default_rng(3).uniform(size=mods.shape[1:]) < 0.05
            ).astype(np.uint8)
    got = tpipe.sample(mods, mask)
    cloud = ref_volume_to_points(mods)
    fg = mask[tuple(cloud.xyz_origin.T)]
    want = ref_sample_cloud(cloud, N, np.random.default_rng(0), foreground=fg)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    probs = tpipe.segment_points(got)
    assert probs.shape == (N, 4) and probs.dtype == np.float32
    np.testing.assert_allclose(probs.sum(1), 1.0, atol=1e-5)


def test_labels_with_reference_mask(models, case):
    jpipe, tpipe = _pipes(models)
    mods = case[1]
    mask = jpipe.binary_map(mods)
    want = np.asarray(jpipe.segment_volume(mods, mask=mask))
    got = tpipe.segment_volume(mods, mask=mask)
    assert got.shape == want.shape == mods.shape[1:]
    assert got.dtype == want.dtype == np.uint8
    o = _pipes(models)[1].sample(mods, mask).xyz_origin
    assert len(np.unique(want[tuple(o.T)])) >= 2
    assert set(np.unique(got)) <= {0, 1, 2, 4}
    assert (got == want).mean() >= 0.993
    assert (got > 0).sum() <= N


def test_segment_volume_whole_path(models, case):
    _, tpipe = _pipes(models)
    labels = tpipe.segment_volume(case[1], postprocess=True)
    assert labels.shape == case[1].shape[1:] and labels.dtype == np.uint8
    assert set(np.unique(labels)) <= {0, 1, 2, 4}


@pytest.fixture
def small_window(monkeypatch):
    """The CLI's BraTS saliency config with the test's attention window
    (the full (64, 160, 160) window is minutes of CPU per case)."""
    real = segment.brats_saliency_config
    monkeypatch.setattr(segment, "brats_saliency_config",
                        lambda **kw: real(**{**PATCH, **kw}))


@pytest.mark.parametrize("flags", [[], ["--postprocess"], ["--fast"]])
def test_segment_cli_on_cpu(case, tmp_path, small_window, flags):
    root, _, seg = case
    out = tmp_path / "out"
    seconds = segment.main([
        "--data_3D_path", root, "--outSegment_path", str(out),
        "--n_point", str(N), "--device", "cpu", *flags,
    ])
    assert list(seconds) == ["case_a"] and seconds["case_a"] > 0
    labels = nifti.load(str(out / "case_a.nii.gz")).data
    assert labels.shape == seg.shape and labels.dtype == np.uint8
    assert set(np.unique(labels)) <= {0, 1, 2, 4}
    assert 0 < (labels > 0).sum() <= N


def _args(**kw):
    base = dict(dataset="brats", fast=False, sa_stride=None, n_point=N,
                saliency_checkpoint=None, pointseg_checkpoint=None)
    return argparse.Namespace(**{**base, **kw})


@pytest.mark.parametrize("fast,stride,bf16", [
    (False, 1, False), (True, 2, True),
])
def test_build_pipeline_configs(fast, stride, bf16):
    p = segment.build_pipeline(_args(fast=fast))
    assert p.scfg.sa_gate_stride == stride and p.scfg.use_bfloat16 == bf16
    assert p.scfg.inference_patch_size == (64, 160, 160)
    assert p.pcfg.num_points == N
    assert segment.build_pipeline(N).scfg == segment.build_pipeline(
        _args(fast=True)).scfg                 # the serving path's models
    q = segment.build_pipeline(_args(dataset="pancreas", sa_stride=2))
    assert q.scfg.in_channels == 1 and q.scfg.sa_gate_stride == 2


def test_checkpoint_flags(tmp_path):
    # a directory without a checkpoint (the JAX package's orbax ones exit
    # naming the exporter: tests/test_torch_checkpoint_bridge.py)
    with pytest.raises(SystemExit, match="no checkpoint found under"):
        segment.build_pipeline(_args(saliency_checkpoint=str(tmp_path)))
    with pytest.raises(SystemExit, match="no checkpoint"):
        segment.build_pipeline(_args(pointseg_checkpoint=str(tmp_path / "x")))
    state = PointSegTrainer(brats_pointseg_config(num_points=N),
                            device="cpu").init_state(seed=5)
    BestMetricCheckpointer(str(tmp_path / "ckpt")).save(state, 3, metric=0.5)
    p = segment.build_pipeline(_args(pointseg_checkpoint=str(tmp_path / "ckpt")))
    for name, t in state.model.state_dict().items():
        assert torch.equal(p.pointseg_model.state_dict()[name], t), name
    assert not p.pointseg_model.training


def test_entry_points_default_to_the_card(models, case, tmp_path, monkeypatch):
    """Without a device argument the pipelines and the CLI ask for CUDA: on
    a host without a card they fail instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sal, pseg, scfg, pcfg = models["port"]
    for build in (
        lambda: PointUnetPipeline(sal, pseg, scfg, pcfg),
        lambda: FusedPointUnet(sal, pseg, scfg, pcfg),
        lambda: segment.main(["--data_3D_path", case[0], "--outSegment_path",
                              str(tmp_path), "--n_point", str(N)]),
    ):
        with pytest.raises((AssertionError, RuntimeError)):
            build()
    assert not os.listdir(tmp_path)
