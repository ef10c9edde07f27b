"""The plain reference against the port at tiny shapes on the CPU, from
the same seeded weights and inputs."""

import pytest
import torch

from perfbench import weights
from perfbench.reference import pyramid as ref_pyramid
from perfbench.reference import randlanet, saliency
from perfbench.tests import tiny


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("config", ["brats", "pancreas"])
def test_saliency_forward(config, stride):
    from pointunet_tpu_torch.core.config import SaliencyConfig
    from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet

    s = dict(tiny.config(config)["saliency"], sa_gate_stride=stride)
    model = SaliencyUNet(SaliencyConfig(in_channels=s["in_channels"],
                                        sa_gate_stride=stride)).eval()
    w = weights.fill(model, 7)
    x = torch.randn((1, s["in_channels"], 16, 32, 32),
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = model(x)
        got = saliency.forward(w, s, x)
    assert (got - want).norm() / want.norm() < 1e-5


def _cloud(n, seed):
    g = torch.Generator().manual_seed(seed)
    flat = torch.randperm(48 * 48 * 32, generator=g)[:n]
    return torch.stack([flat // (48 * 32), (flat // 32) % 48, flat % 32], 1).float() / 48


@pytest.mark.parametrize("n", [2048, 20000])
def test_pyramid_equals_port(n):
    """The reference pyramid equals the port's plain one row for row: the
    cell-window search above 16,384 points, the exact one below."""
    from pointunet_tpu_torch.ops.pyramid import build_pyramid

    xyz = _cloud(n, n)
    port = build_pyramid(xyz, 16, (4, 4, 4, 4, 2))
    ref = ref_pyramid.build(xyz, 16, (4, 4, 4, 4, 2))
    assert torch.equal(port.order.long(), ref.order)
    for i in range(5):
        assert torch.equal(port.xyz[i], ref.xyz[i])
        assert torch.equal(port.neigh_idx[i], ref.neigh[i])
        assert torch.equal(port.sub_idx[i], ref.sub[i])
        assert torch.equal(port.interp_idx[i], ref.interp[i])


@pytest.mark.parametrize("train", [False, True])
def test_randlanet_forward(train):
    from pointunet_tpu_torch.core.config import PointSegConfig
    from pointunet_tpu_torch.models.randlanet import RandLANet
    from pointunet_tpu_torch.ops.pyramid import build_pyramid_batch

    p = tiny.config("brats")["pointseg"]
    cfg = PointSegConfig(num_points=p["num_points"], use_bfloat16=False,
                         dropout_rate=0.0)
    model = RandLANet(cfg)
    model.train(train)
    w = weights.fill(model, 9)
    xyz = _cloud(p["num_points"], 3)
    feats = torch.cat([xyz, torch.randn((xyz.shape[0], 4),
                                        generator=torch.Generator().manual_seed(2))], 1)
    pyr = build_pyramid_batch(xyz[None], 16, cfg.sub_sampling_ratio)
    order = pyr.order[0].long()
    with torch.no_grad():
        want = model(feats[order][None], pyr)[0]
    ref = ref_pyramid.build(xyz, 16, cfg.sub_sampling_ratio)
    with torch.no_grad():
        got = randlanet.forward(w, 5, feats[ref.order], ref.xyz, ref.neigh, ref.sub,
                                ref.interp, train=train)
    assert (got - want).norm() / want.norm() < 1e-5


@pytest.mark.parametrize("cell", ["brats.serve", "pancreas.serve",
                                  "brats.train_point", "brats.train_saliency"])
def test_sound_run_is_correct(cell):
    """A whole run of the cell at a tiny size on the CPU: the port's
    outputs pass every limit."""
    from perfbench import manifest, run

    w = manifest.workload(manifest.load(), cell)
    r = run.execute(cell, 2 ** 31 + 17, 0.5, False, torch.device("cpu"), 0.0,
                    cfg=tiny.config(w["config"]), traffic=tiny.traffic(w["traffic"]))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    printed = [k for k in r if k not in ("errors", "phases", "readings")]
    assert printed[-1] == "checks"
