"""Port RandLA-Net (pointunet_tpu_torch/models/randlanet.py) and its weight
converter against the reference, at the shape of
``__graft_entry__.entry()``: 4,096 points, the full BraTS widths, f32.

The reference's own pyramid is fed to both models, so KNN ties cannot
confound the comparison. Tolerance atol = rtol = 1e-4 on the logits: f32
throughout, differing only in summation order over five encoder and five
decoder levels (observed max abs difference ~1.3e-4 at logits of ~30).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.core.config import brats_pointseg_config as jax_cfg
from pointunet_tpu.models.randlanet import init_randlanet as jax_init
from pointunet_tpu.ops.pyramid import build_pyramid_batch
from pointunet_tpu_torch.convert import convert_randlanet
from pointunet_tpu_torch.core.config import brats_pointseg_config
from pointunet_tpu_torch.models.randlanet import RandLANet, init_randlanet
from pointunet_tpu_torch.ops.pyramid import Pyramid
from torch_parity import flat_variables, to_torch

torch.set_num_threads(1)

N = 4096


@pytest.fixture(scope="module")
def reference():
    cfg = jax_cfg(num_points=N)
    model, variables = jax_init(jax.random.PRNGKey(0), cfg, num_points=N)
    rng = np.random.default_rng(0)
    xyz = rng.uniform(0, 1, (1, N, 3)).astype(np.float32)
    feats = np.concatenate(
        [xyz, rng.standard_normal((1, N, 4)).astype(np.float32)], -1
    )
    pyr = build_pyramid_batch(jnp.asarray(xyz), cfg.k_n, cfg.sub_sampling_ratio)
    feats = jnp.take_along_axis(jnp.asarray(feats), pyr.order[..., None], 1)
    logits = jax.jit(lambda f, p: model.apply(variables, f, p, train=False))(
        feats, pyr
    )
    return flat_variables(variables), pyr, np.asarray(feats), np.asarray(logits)


def test_randlanet_matches_reference(reference):
    flat, pyr, feats, want = reference
    cfg = brats_pointseg_config(num_points=N)
    model = RandLANet(cfg)
    model.load_state_dict(convert_randlanet(flat, cfg))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(feats), Pyramid(*to_torch(pyr)))
    assert got.dtype == torch.float32
    assert got.shape == (1, N, 4)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


def test_convert_randlanet_rejects_bad_variables(reference):
    flat = reference[0]
    cfg = brats_pointseg_config(num_points=N)
    extra = dict(flat, **{"params/Dense_9/kernel": np.zeros((2, 2))})
    with pytest.raises(KeyError, match="no port counterpart"):
        convert_randlanet(extra, cfg)
    missing = dict(flat)
    missing.pop("batch_stats/BatchNorm_0/var")
    with pytest.raises(KeyError, match="no variable"):
        convert_randlanet(missing, cfg)
    key = "params/Dense_0/kernel"
    wrong = dict(flat, **{key: flat[key][:, :4]})
    with pytest.raises(ValueError, match="does not match"):
        convert_randlanet(wrong, cfg)


def test_init_randlanet_draws_reference_schemes():
    cfg = brats_pointseg_config(num_points=N)
    m1 = init_randlanet(cfg, torch.Generator().manual_seed(0))
    m2 = init_randlanet(cfg, torch.Generator().manual_seed(0))
    assert not m1.training
    for (n1, a), (_, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
        assert torch.equal(a, b), n1
    # He truncated normal over fan_out (out = 1024 rows)
    w = m1.bottleneck.dense.weight.detach()
    std = np.sqrt(2.0 / w.shape[0])
    assert abs(float(w.std()) / std - 1) < 0.05
    assert float(w.abs().max()) <= 2 * std / 0.87962566103423978 + 1e-6
    # glorot uniform for fc0 and the attention scores
    lim = np.sqrt(6.0 / (7 + 8))
    assert float(m1.fc0.weight.detach().abs().max()) <= lim
    assert float(m1.bn0.running_var.min()) == 1.0
    assert all(float(b.detach().abs().max()) == 0 for n, b in m1.named_parameters()
               if n.endswith("Dense_0.bias"))
