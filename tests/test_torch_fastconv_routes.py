"""The conv routes of the port's ``models/fastconv.py`` against the
reference's ``FastConv`` (``pointunet_tpu/models/fastconv.py``), and the
2-D attention gates of ``models/attention3d.py`` against flax's.

The same numpy inputs (``default_rng`` seeds) and the reference's own
flax init, converted by ``convert.py``, go through both packages on the
CPU, with ``POINTUNET_FASTCONV`` and ``POINTUNET_FUSED_UPSAMPLE`` set alike
on both sides. Bars:

* f32: rtol 2e-4, atol 2e-5 (the reference's own bar for its fold,
  tests/test_fastconv.py); the fused upsample conv rtol = atol = 1e-5
  (its bar there); both sum the same products in another order;
* bf16: within 2 bf16 ulps of the larger magnitude, or within 1e-2 x
  max|reference| where the bf16 partial sums of a fold cancel (each
  rounds to bf16 before the sum, on both sides but in other orders, and
  kernel 3, which ``pallas`` takes for a 3x3x3 conv, rounds only once);
* ``SaliencyUNet`` logits: atol 3e-4, rtol 1e-4 (the bar of
  tests/test_torch_saliency.py);
* the 2-D gates: atol = rtol = 1e-5.

The reference on the CPU takes, under ``pallas``, its fold for the 3x3x3
convs too (its Pallas conv runs only on a TPU); the port sends them to
kernel 3, whose plain version computes the same conv.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.core.config import brats_saliency_config as jax_cfg
from pointunet_tpu.models import attention3d as ref_att
from pointunet_tpu.models import fastconv as ref_fc
from pointunet_tpu.models.saliency_unet import init_saliency_unet as jax_init
from pointunet_tpu_torch.convert import convert_saliency, convert_variables
from pointunet_tpu_torch.core.config import brats_saliency_config
from pointunet_tpu_torch.models import attention3d, fastconv
from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet
from pointunet_tpu_torch.ops import conv_cuda
from torch_parity import flat_variables

torch.set_num_threads(1)

KERNELS = [(3, 3, 3), (1, 9, 9), (9, 1, 9), (9, 9, 1), (9, 1, 1), (1, 9, 1),
           (1, 1, 9), (1, 1, 1)]
# the convs each mode folds (stride 1, dilation 1); ``pallas`` sends the
# 3x3x3 conv to kernel 3
FOLDED = {
    "off": set(),
    "all": set(KERNELS),
    "fold1": set(KERNELS) - {(3, 3, 3)},
    "k9": set(KERNELS) - {(3, 3, 3), (1, 1, 1)},
    "pallas": set(KERNELS) - {(3, 3, 3)},
}
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def assert_close(got: torch.Tensor, want, dtype: str, rtol=2e-4, atol=2e-5):
    """``got`` (channels-first) against the reference's channels-last
    ``want`` at the bar of ``dtype``; returns the largest gap."""
    g = got.float().movedim(1, -1).numpy()
    w = np.asarray(jnp.asarray(want, jnp.float32))
    assert g.shape == w.shape
    gap = np.abs(g - w)
    if dtype == "f32":
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    else:
        ulp = _bf16_ulp(np.maximum(np.abs(g), np.abs(w)))
        ok = (gap <= 2 * ulp) | (gap <= 1e-2 * np.abs(w).max())
        assert ok.all(), (float(gap.max()), int((~ok).sum()))
    return float(gap.max())


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_fast_conv3d_matches_reference(kernel, dtype):
    """Every fold axis of every kernel: 2-D convs over the folded slices,
    shifted and summed in the compute type."""
    tdt, jdt = DTYPES[dtype]
    x = _x((2, 6, 10, 11, 5), 0)                          # (B, D, H, W, C)
    w = _x(kernel + (5, 4), 1) * 0.2                      # DHWIO
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(tdt)
    wt = torch.from_numpy(w).permute(4, 3, 0, 1, 2).to(tdt)
    for axis in range(3):
        want = jax.jit(ref_fc.fast_conv3d, static_argnums=2)(
            jnp.asarray(x, jdt), jnp.asarray(w, jdt), axis)
        got = fastconv.fast_conv3d(xt, wt, axis)
        assert got.dtype == tdt and got.is_contiguous()
        assert_close(got, want, dtype)


def _conv_pair(kernel, strides=1, dilation=1, dtype="f32", upsample=1):
    """(reference FastConv and its variables, the port's Conv with them
    converted) for 5 -> 4 channels; the weights are drawn from a seed in
    the reference's layout (its parameter tree: ``kernel``, ``bias``)."""
    tdt, jdt = DTYPES[dtype]
    ref = ref_fc.FastConv(4, kernel, strides=strides,
                          kernel_dilation=dilation, upsample=upsample,
                          dtype=jdt)
    variables = {"params": {"kernel": jnp.asarray(_x(kernel + (5, 4), 10)
                                                  * 0.2),
                            "bias": jnp.asarray(_x((4,), 11))}}
    port = torch.nn.ModuleDict({"Conv_0": fastconv.Conv(
        5, 4, kernel, strides=strides, kernel_dilation=dilation,
        upsample=upsample, dtype=tdt if dtype == "bf16" else None)})
    flat = {k.replace("params/", "params/Conv_0/"): v
            for k, v in flat_variables(variables).items()}
    port.load_state_dict(convert_variables(flat, port))
    return ref, variables, port["Conv_0"]


def _count_routes(monkeypatch):
    """Calls of kernel 3's wrapper and of the fold, by route name."""
    taken = []
    for name, route in (("conv3d_3x3", "kernel3"), ("fast_conv3d", "fold")):
        real = getattr(fastconv, name)

        def wrap(*a, _real=real, _route=route):
            taken.append(_route)
            return _real(*a)

        monkeypatch.setattr(fastconv, name, wrap)
    return taken


CONVS = ([(k, 1, 1) for k in KERNELS]
         + [((3, 3, 3), 2, 1), ((1, 9, 9), 2, 1), ((3, 3, 3), 1, 3)])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("mode", ["off", "all", "fold1", "k9", "pallas"])
def test_conv_routes_match_reference(mode, dtype, monkeypatch):
    """Each mode takes the reference's route for each conv (strided and
    dilated convs: ``F.conv3d`` in every mode) and matches FastConv under
    the same mode."""
    monkeypatch.setenv("POINTUNET_FASTCONV", mode)
    taken = _count_routes(monkeypatch)
    x = _x((2, 6, 10, 11, 5), 2)
    before = conv_cuda.LAUNCHES
    for kernel, stride, dilation in CONVS:
        ref, variables, port = _conv_pair(kernel, stride, dilation, dtype)
        want = jax.jit(ref.apply)(variables, jnp.asarray(x))
        del taken[:]
        with torch.no_grad():
            got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
        unit = stride == dilation == 1
        route = ("kernel3" if unit and mode == "pallas" and kernel == (3, 3, 3)
                 else "fold" if unit and kernel in FOLDED[mode] else None)
        assert taken == ([route] if route else []), (kernel, stride, taken)
        assert_close(got, want, dtype)
    assert conv_cuda.LAUNCHES == before


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_fused_upsample_conv3d_matches_reference(scale, dtype):
    tdt, jdt = DTYPES[dtype]
    x = _x((1, 3, 4, 5, 6), 3)
    w = _x((3, 3, 3, 6, 7), 4) * 0.3
    want = ref_fc.fused_upsample_conv3d(
        jnp.asarray(x, jdt), jnp.asarray(w, jdt), scale)
    got = fastconv.fused_upsample_conv3d(
        torch.from_numpy(x).permute(0, 4, 1, 2, 3).to(tdt),
        torch.from_numpy(w).permute(4, 3, 0, 1, 2).to(tdt), scale)
    assert got.dtype == tdt
    assert_close(got, want, dtype, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("fused", ["1", "0"])
@pytest.mark.parametrize("scale", [2, 3, 4])
def test_upsample_conv_matches_reference(scale, fused, monkeypatch):
    """``Conv(upsample=s)`` with the fused route on and off, against
    FastConv under the same setting; the fused route is taken only when
    asked for."""
    monkeypatch.setenv("POINTUNET_FUSED_UPSAMPLE", fused)
    calls = []
    real = fastconv.fused_upsample_conv3d
    monkeypatch.setattr(fastconv, "fused_upsample_conv3d",
                        lambda *a: calls.append(a) or real(*a))
    x = _x((1, 3, 4, 4, 5), 5)
    ref, variables, port = _conv_pair((3, 3, 3), upsample=scale)
    want = ref.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert len(calls) == (fused == "1")
    assert_close(got, want, "f32", rtol=1e-5, atol=1e-5)


@functools.lru_cache(maxsize=None)
def _reference_net(stride):
    return jax_init(jax.random.PRNGKey(0), jax_cfg(sa_gate_stride=stride))


@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("mode", ["fold1", "pallas"])
def test_saliency_unet_under_route_matches_reference(mode, stride,
                                                     monkeypatch):
    """The whole net at (16, 32, 32), f32, with the routes set on both
    sides: ``pallas`` folds the gate's and the 1x1x1 convs and sends the
    19 stride-1 3x3x3 convs to kernel 3 (its plain version here)."""
    monkeypatch.setenv("POINTUNET_FASTCONV", mode)
    taken = _count_routes(monkeypatch)
    model, variables = _reference_net(stride)
    x = _x((1, 16, 32, 32, 4), 6 + stride)
    want = jax.jit(lambda v: model.apply(variables, v, train=False))(
        jnp.asarray(x))
    cfg = brats_saliency_config(sa_gate_stride=stride)
    port = SaliencyUNet(cfg)
    port.load_state_dict(convert_saliency(flat_variables(variables), cfg))
    before = conv_cuda.LAUNCHES
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert conv_cuda.LAUNCHES == before
    # the 6 gate convs and the four 1x1x1s (the CFE branches, c345) fold
    # in both modes
    assert taken.count("kernel3") == (19 if mode == "pallas" else 0)
    assert taken.count("fold") == 10
    assert_close(got, want, "f32", rtol=1e-4, atol=3e-4)


@pytest.mark.parametrize("instance_norm", [True, False])
def test_2d_attention_gates_match_reference(instance_norm):
    x = _x((2, 12, 14, 8), 9)                              # (B, H, W, C)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    for ref, port in (
        (ref_att.SpatialAttention2D(8, instance_norm=instance_norm),
         attention3d.SpatialAttention2D(8, instance_norm=instance_norm)),
        (ref_att.ChannelWiseAttention2D(),
         attention3d.ChannelWiseAttention2D(8)),
    ):
        variables = ref.init(jax.random.PRNGKey(1), jnp.asarray(x))
        want = ref.apply(variables, jnp.asarray(x))
        port.load_state_dict(convert_variables(flat_variables(variables),
                                               port))
        with torch.no_grad():
            got = port.eval()(xt)
        assert got.shape == xt.shape
        assert_close(got, want, "f32", rtol=1e-5, atol=1e-5)
