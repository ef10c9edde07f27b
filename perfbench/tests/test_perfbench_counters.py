"""The count file against counts taken by hand: every conv and dense call
of the plain reference at a tiny size, its multiply-adds read off the
call's shapes."""
import math

import pytest
import torch
import torch.nn.functional as F

from perfbench import manifest, weights
from perfbench.reference import pyramid as ref_pyramid
from perfbench.reference import randlanet, saliency
from perfbench.tests import tiny

counter = manifest.module("counters", "pointunet")


def _counting(monkeypatch):
    ops = {"n": 0}
    conv3d, linear = F.conv3d, F.linear

    def counted_conv(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = conv3d(x, w, b, stride, padding, dilation, groups)
        ops["n"] += 2 * w.numel() * y[0, 0].numel() * y.shape[0]
        return y

    def counted_linear(x, w, b=None):
        ops["n"] += 2 * w.numel() * (x.numel() // x.shape[-1])
        return linear(x, w, b)

    monkeypatch.setattr(F, "conv3d", counted_conv)
    monkeypatch.setattr(F, "linear", counted_linear)
    return ops


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("base", [16, 8])
def test_saliency_forward(monkeypatch, stride, base):
    from pointunet_tpu_torch.core.config import SaliencyConfig
    from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet

    cfg = tiny.config("brats")
    s = dict(cfg["saliency"], base_filter=base, sa_gate_stride=stride)
    model = SaliencyUNet(SaliencyConfig(base_filter=base, in_channels=s["in_channels"]))
    w = weights.fill(model, 3)
    dhw = (16, 32, 48)
    ops = _counting(monkeypatch)
    with torch.no_grad():
        saliency.forward(w, s, torch.zeros((1, s["in_channels"]) + dhw))
    assert counter.saliency_forward(s, dhw, stride)["ops"] == ops["n"]
    params = sum(v.numel() for k, v in w.items()
                 if k.endswith("weight") and v.ndim > 1)
    assert counter.saliency_forward(s, dhw, stride)["params"] == params


def test_pointnet_forward(monkeypatch):
    from pointunet_tpu_torch.core.config import PointSegConfig
    from pointunet_tpu_torch.models.randlanet import RandLANet

    cfg = tiny.config("brats")
    p = cfg["pointseg"]
    model = RandLANet(PointSegConfig(num_points=p["num_points"]))
    w = weights.fill(model, 4)
    n = p["num_points"]
    g = torch.Generator().manual_seed(0)
    xyz = torch.rand((n, 3), generator=g)
    pyr = ref_pyramid.build(xyz, p["k_n"], p["sub_sampling_ratio"])
    feats = torch.rand((n, 3 + p["num_features"]), generator=g)
    ops = _counting(monkeypatch)
    with torch.no_grad():
        randlanet.forward(w, p["num_layers"], feats, pyr.xyz, pyr.neigh, pyr.sub,
                          pyr.interp)
    sizes = counter.level_sizes(p, n)
    pooled_sums = sum(2 * 2 * 2 * (d // 2) * sizes[i] * p["k_n"]
                      for i, d in enumerate(p["d_out"]))
    assert counter.pointnet_forward(p, n) == ops["n"] + pooled_sums


def test_pyramid_bytes_by_hand():
    p = {"k_n": 2, "num_layers": 2, "sub_sampling_ratio": [2, 2]}
    # cloud 8 points: read 8x3 f32 + order 8 int32; level 0 (8 points):
    # points 8x3x4, neighbours 8x2x4, kept points' 4x2x4, nearest 8x4;
    # level 1 (4): 4x3x4, 4x2x4, 2x2x4, 4x4; the last level's 2x3x4
    want = (96 + 32) + (96 + 64 + 32 + 32) + (48 + 32 + 16 + 16) + 24
    assert counter.pyramid_bytes(p, 8) == want


def test_serve_work_brats():
    cfg = manifest.read_json("configs", "brats")
    work = counter.serve(cfg)
    dhw, roi = counter.serve_roi(cfg)
    assert dhw == (160, 208, 192) and roi == [192, 208, 155]
    assert work["attention_bytes"] > 4 * 4 * math.prod(roi)
    assert counter.serve(manifest.read_json("configs", "pancreas"))["attention_ops"] > work["attention_ops"]
