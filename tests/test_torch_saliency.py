"""Port saliency U-Net (pointunet_tpu_torch/models/saliency_unet.py) and its
weight converter against the reference: a (16, 32, 32) patch, 4 input
channels, the full widths, f32, with the spatial-attention gate at stride
1 and 2.

Tolerance on the logits: atol 3e-4, rtol 1e-4. Both sides run f32, but
flax's GroupNorm takes the variance as E[x^2] - E[x]^2 while PyTorch
uses two passes, and conv sums run in another order; through ~40
conv+norm layers that leaves ~8e-5 of absolute difference at logits of
~4 (observed), inside the bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from pointunet_tpu.core.config import brats_saliency_config as jax_cfg
from pointunet_tpu.models.saliency_unet import init_saliency_unet as jax_init
from pointunet_tpu_torch.convert import convert_saliency
from pointunet_tpu_torch.core.config import brats_saliency_config
from pointunet_tpu_torch.models.fastconv import Conv, same_padding
from pointunet_tpu_torch.models.saliency_unet import (
    SaliencyUNet,
    init_saliency_unet,
)
from torch_parity import flat_variables

torch.set_num_threads(1)


@pytest.mark.parametrize("stride", [1, 2])
def test_saliency_unet_matches_reference(stride):
    model, variables = jax_init(
        jax.random.PRNGKey(0), jax_cfg(sa_gate_stride=stride)
    )
    x = np.random.default_rng(stride).standard_normal(
        (1, 16, 32, 32, 4)
    ).astype(np.float32)
    want = np.asarray(
        jax.jit(lambda v: model.apply(variables, v, train=False))(
            jnp.asarray(x)
        )
    )
    cfg = brats_saliency_config(sa_gate_stride=stride)
    port = SaliencyUNet(cfg)
    port.load_state_dict(convert_saliency(flat_variables(variables), cfg))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.dtype == torch.float32 and got.shape == (1, 2, 16, 32, 32)
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 4, 1).numpy(), want, atol=3e-4, rtol=1e-4
    )


def test_stride2_same_pad_on_even_input():
    """XLA pads a stride-2 3x3x3 SAME conv of an even axis by (0, 1);
    torch's padding=1 would pad (1, 1) and shift every output voxel."""
    assert same_padding((8, 6, 4), (3, 3, 3), (2, 2, 2), (1, 1, 1)) == [
        (0, 1)
    ] * 3
    assert same_padding((16,), (3,), (1,), (7,)) == [(7, 7)]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, 8, 6, 4, 3)).astype(np.float32)     # NDHWC
    w = rng.standard_normal((3, 3, 3, 3, 5)).astype(np.float32)     # DHWIO
    want = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2, 2), "SAME",
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )
    conv = Conv(3, 5, 3, strides=2, use_bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))
        got = conv(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.shape == (1, 5, 4, 3, 2)
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 4, 1).numpy(), np.asarray(want),
        atol=1e-5, rtol=1e-5,
    )
    # the symmetric torch padding differs: the explicit rule matters
    naive = F.conv3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3), conv.weight, stride=2,
        padding=1,
    )
    assert not np.allclose(naive.detach().numpy(), got.numpy(), atol=1e-3)


@pytest.mark.parametrize("shape", [(4, 6, 8), (3, 5, 7)])
def test_trilinear_resize_matches_reference(shape):
    """jax.image.resize(..., "trilinear") (the stride-2 gate, the fused
    path's att_downscale) against F.interpolate(align_corners=False)."""
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    out = tuple(2 * s for s in shape)
    want = np.asarray(jax.image.resize(jnp.asarray(x), out, "trilinear"))
    got = F.interpolate(
        torch.from_numpy(x)[None, None], size=out, mode="trilinear",
        align_corners=False,
    )[0, 0].numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_convert_saliency_rejects_bad_variables():
    cfg = brats_saliency_config()
    model = init_saliency_unet(cfg, torch.Generator().manual_seed(0))
    flat = {}
    for name, t in model.state_dict().items():
        *path, leaf = name.split(".")
        leaf = {"weight": "kernel" if t.ndim > 1 else "scale",
                "bias": "bias"}[leaf]
        arr = t.numpy()
        if t.ndim == 5:                    # OIDHW -> DHWIO
            arr = arr.transpose(2, 3, 4, 1, 0)
        elif t.ndim == 2:                  # (out, in) -> (in, out)
            arr = arr.T
        flat["/".join(["params"] + path + [leaf])] = arr
    sd = convert_saliency(flat, cfg)
    for name, t in model.state_dict().items():
        assert torch.equal(sd[name], t), name
    key = next(k for k in flat if k.endswith("/kernel"))
    with pytest.raises(ValueError, match="does not match"):
        convert_saliency(dict(flat, **{key: flat[key][..., :1]}), cfg)
    with pytest.raises(KeyError, match="unconvertible"):
        convert_saliency(dict(flat, **{"params/Conv_0/weight": 0}), cfg)
