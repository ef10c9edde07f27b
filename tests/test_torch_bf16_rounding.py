"""The port's saliency-net modules and its ``BatchNorm`` in bf16 against
flax's at ``dtype=bf16`` (pointunet_tpu/models/saliency_unet.py,
attention3d.py, norms.py; ``flax.linen.BatchNorm``), on the CPU.

Each module kind of the saliency net (``ConvNormRelu`` with instance norm
as a dense, a strided and a dilated conv; ``CFE3D``; ``UpsampleConv``;
``SpatialAttention3D`` at gate stride 1, and at stride 2 with its pooling
and resize; ``ChannelWiseAttention3D``; the f32-logit head; ``NormRelu``
alone) and the point net's ``BatchNorm`` in eval and train mode run on
the same bf16 inputs (numpy, seeded) with the same weights, the norms'
scale, bias and running statistics drawn away from 1 and 0 (bf16 holds
those exactly and would hide a cast). Flax runs op by op: every op's
output rounded to its declared type. (Under ``jax.jit`` XLA:CPU keeps
fused intermediates in f32 where a bf16 round trip would drop them: the
jitted dilated ``ConvNormRelu`` is 2,496 ulps from its op-by-op self at
its worst element, measured.)

* The forward (with autograd recording and without), as the largest
  |port - flax| over the elements in bf16 ulps of flax's value
  (``_ulps``: values below 2^-16 of the tensor's largest counted at that
  floor, where f32 sums of terms of the largest's size cancel): within
  one ulp, both sides rounding an f32 value once (measured 0 or 1). Two
  departures stay: ``CFE3D`` 3 ulps at its worst element under the
  suite's XLA flags (1 without them), where XLA's and PyTorch's f32 conv
  sums round to neighbouring bf16 values and the norm after the conv
  scales that ulp by rsqrt(var) * scale (bar 4); the stride-2 gate 2
  ulps (bar 2): flax's ``avg_pool`` sums the bf16 input in bf16, up to
  832 ulps from the exact mean, the port's in f32 (0.5).
* The gradients of one fixed cotangent (the input's and each
  parameter's; the conv biases that feed an instance norm left out, zero
  analytically) as their relative distance from the exact gradient (the
  port's module in f64 from the same bf16 weights and input): the
  port's within 1.5x flax's + 2^-8 (measured, port / flax: 0.0294 /
  0.0294 dense, 0.0028 / 0.0033 strided, 0.0054 / 0.0056 dilated,
  0.0105 / 0.0107 CFE3D, 0.0070 / 0.0073 upsample, 0.0739 / 0.0750 and
  0.0456 / 0.0436 the gate at stride 1 and 2, the mean over 4 inputs
  (one input's error is a matter of which relu of its 1-channel norms
  flips), 0.0020 both channel attention, 0.0024 / 0.0031 head, 0.0022 /
  0.0024 ``NormRelu``, 0.0018 / 0.0018 and 0.0019 / 0.0020 the batch
  norm in eval and train mode). The port's bf16 instance norm computes
  its input gradient in f32 and rounds it once; flax's backward rounds
  each cotangent to its declared type, so neither matches the
  other ulp for ulp.

The port before these repairs (commit 2d792ac) failed 10 of these 12
(the instance norm 628 ulps from flax, the batch norm 1,252, the head
1,816: affine terms cast to bf16, the conv bias fused into the conv's
f32 sums on the CPU, the channel attention's product in bf16).
"""
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax.traverse_util import unflatten_dict

from pointunet_tpu.models import saliency_unet as ref
from pointunet_tpu.models.attention3d import (
    ChannelWiseAttention3D as RefCA,
    SpatialAttention3D as RefSA,
)
from pointunet_tpu.models.fastconv import FastConv as RefConv
from pointunet_tpu.models.norms import NormRelu as RefNormRelu
from pointunet_tpu_torch.convert import convert_variables
from pointunet_tpu_torch.models import saliency_unet as port
from pointunet_tpu_torch.models.attention3d import (
    ChannelWiseAttention3D,
    SpatialAttention3D,
)
from pointunet_tpu_torch.models.fastconv import Conv
from pointunet_tpu_torch.models.naming import FlaxNamed
from pointunet_tpu_torch.models.norms import BatchNorm, NormRelu
from torch_parity import flat_variables, named_to_flax_flat

torch.set_num_threads(2)

BF = jnp.bfloat16
C = 16
SHAPE = (1, 8, 16, 16, C)           # (B, D, H, W, C), channels last
# the bars and their measurements: the module docstring
FORWARD_ULPS = {"cfe3d": 4.0, "spatial_attention_stride2": 2.0}
GRAD_FACTOR = 1.5
GRAD_SLACK = 2.0 ** -8
# the 1-channel norms of the gate make one input's gradient error a
# matter of chance (a relu or a rounding that flips): summed over 4
SEEDS = {"spatial_attention_stride1": 4, "spatial_attention_stride2": 4}
# conv biases that feed an instance norm (all but the head's)
BIAS_BEFORE_NORM = re.compile(r"Conv_\d+/bias$")


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """max |got - want| in bf16 ulps of ``want`` (floored at 2^-16 of its
    largest |value|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    a = np.abs(want)
    a = np.maximum(a, 2.0 ** -16 * max(float(a.max()), 1e-30))
    return float((np.abs(got - want) / np.exp2(np.floor(np.log2(a)) - 7))
                 .max())


class _Head(nn.Module):
    """The saliency net's last conv: bf16, logits cast to f32."""

    @nn.compact
    def __call__(self, x):
        return RefConv(2, (3, 3, 3), padding="SAME", dtype=BF)(x).astype(
            jnp.float32)


class _PortHead(FlaxNamed):
    def __init__(self):
        super().__init__()
        self.child("Conv", Conv(C, 2, 3, dtype=torch.bfloat16), "conv")

    def forward(self, x):
        return self.conv(x).float()


class _StridedGate(nn.Module):
    """``SaliencyUNet``'s gate at stride 2: the attention on the pooled
    input, its 1-channel gate resized back."""

    @nn.compact
    def __call__(self, x):
        g = nn.avg_pool(x, (2, 2, 2), strides=(2, 2, 2), padding="VALID")
        g = RefSA(C, dtype=BF, broadcast=False)(g)
        return jax.image.resize(g, g.shape[:1] + x.shape[1:4] + (1,),
                                "trilinear")


class _PortStridedGate(FlaxNamed):
    def __init__(self):
        super().__init__()
        self.child("SpatialAttention3D", SpatialAttention3D(
            C, dtype=torch.bfloat16, broadcast=False), "sa")

    def forward(self, x):
        return port.strided_gate(self.sa, x, 2, lambda m, h: m(h))


BF16 = torch.bfloat16
MODULES = {
    "conv_norm_relu": (lambda: ref.ConvNormRelu(C, dtype=BF),
                       lambda: port.ConvNormRelu(C, C, dtype=BF16)),
    "conv_norm_relu_strided": (
        lambda: ref.ConvNormRelu(C, strides=(2, 2, 2), dtype=BF),
        lambda: port.ConvNormRelu(C, C, strides=(2, 2, 2), dtype=BF16)),
    "conv_norm_relu_dilated": (
        lambda: ref.ConvNormRelu(C, dilation=(5, 5, 5), use_bias=False,
                                 dtype=BF),
        lambda: port.ConvNormRelu(C, C, dilation=(5, 5, 5), use_bias=False,
                                  dtype=BF16)),
    "cfe3d": (lambda: ref.CFE3D(8, dtype=BF),
              lambda: port.CFE3D(C, 8, dtype=BF16)),
    "upsample_conv": (lambda: ref.UpsampleConv(2, C, dtype=BF),
                      lambda: port.UpsampleConv(C, 2, C, dtype=BF16)),
    "spatial_attention_stride1": (lambda: RefSA(C, dtype=BF),
                                  lambda: SpatialAttention3D(C, dtype=BF16)),
    "spatial_attention_stride2": (_StridedGate, _PortStridedGate),
    "channel_attention": (RefCA, lambda: ChannelWiseAttention3D(C)),
    "head": (_Head, _PortHead),
    "norm_relu": (lambda: RefNormRelu(dtype=BF), lambda: NormRelu(C)),
}
INPUT = {"upsample_conv": (1, 4, 8, 8, C)}


def _draw(variables: dict, rng) -> dict:
    """Every scale in [0.5, 1.5], every bias ~ 0.3 N(0, 1), running means
    ~ N(0, 1) and variances in [0.5, 1.5]; kernels as flax drew them."""
    out = {}
    for key, v in flat_variables(variables).items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf in ("scale", "var"):
            v = rng.uniform(0.5, 1.5, v.shape)
        elif leaf in ("bias", "mean"):
            v = (0.3 if leaf == "bias" else 1.0) * rng.standard_normal(
                v.shape)
        out[key] = np.asarray(v, np.float32)
    return out


def _nest(flat: dict) -> dict:
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def _to_port(x: np.ndarray, channels_last: bool = False) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x)).to(torch.bfloat16)
    return t if channels_last else t.permute(0, 4, 1, 2, 3).contiguous()


def _from_port(t: torch.Tensor, channels_last: bool = False) -> np.ndarray:
    t = t.detach()
    t = t if t.dtype == torch.float64 else t.float()
    return (t if channels_last else t.permute(0, 2, 3, 4, 1)).numpy()


def _compare(flax_mod, port_mod, x, channels_last=False, mutable=False):
    """Flax's and the port's forward, input gradient and parameter
    gradients (flat flax keys) of one fixed cotangent; the port's forward
    also without autograd. Returns (flax, port) dicts."""
    rng = np.random.default_rng(1)
    xb = jnp.asarray(x, BF)
    flat = _draw(flax_mod.init(jax.random.PRNGKey(0), xb), rng)
    port_mod.load_state_dict(convert_variables(flat, port_mod))
    port_mod.zero_grad(set_to_none=True)
    variables = _nest(flat)
    params = variables["params"]
    rest = {k: v for k, v in variables.items() if k != "params"}

    def fwd(p, xx):
        out = flax_mod.apply({"params": p, **rest}, xx,
                             mutable=["batch_stats"] if mutable else False)
        return out if mutable else (out, {})

    (y, stats), vjp_fn = jax.vjp(fwd, params, xb)
    ct = rng.standard_normal(y.shape).astype(np.float32)
    gp, gx = vjp_fn((jnp.asarray(ct, y.dtype),
                     jax.tree_util.tree_map(jnp.zeros_like, stats)))
    want = {"y": np.asarray(y.astype(jnp.float32)),
            "dx": np.asarray(gx.astype(jnp.float32)),
            "params": flat_variables({"params": gp}),
            "stats": flat_variables(stats) if stats else {}}

    xt = _to_port(np.asarray(xb.astype(jnp.float32)), channels_last)
    with torch.no_grad():
        y_nograd = port_mod(xt.clone())
    # (a train-mode batch norm's no-grad call updated its statistics)
    port_mod.load_state_dict(convert_variables(flat, port_mod))
    xt.requires_grad_()
    yt = port_mod(xt)
    yt.backward(torch.from_numpy(
        ct if channels_last else np.ascontiguousarray(
            ct.transpose(0, 4, 1, 2, 3))).to(yt.dtype))
    got = {"y": _from_port(yt, channels_last),
           "y_nograd": _from_port(y_nograd, channels_last),
           "dx": _from_port(xt.grad, channels_last),
           "params": named_to_flax_flat(
               {n: p.grad for n, p in port_mod.named_parameters()}),
           "stats": named_to_flax_flat(dict(port_mod.named_buffers()))}
    assert yt.dtype == (torch.float32 if y.dtype == jnp.float32
                        else torch.bfloat16)
    exact = _exact(port_mod, flat, xt.detach(), ct, channels_last)
    return want, got, exact


def _exact(port_mod, flat, xt, ct, channels_last) -> dict:
    """The module's input and parameter gradients in f64 from the same
    values, unrounded: the port's module copied to f64 with its convs'
    bf16 weights and biases as bf16 holds them and no cast in its
    convs."""
    model = copy.deepcopy(port_mod)
    model.load_state_dict(convert_variables(flat, model))
    model = model.double()
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, Conv):
                m.dtype = None
                for p in m.parameters():
                    p.copy_(p.to(torch.bfloat16).double())
    x = xt.double().requires_grad_()
    y = model(x)
    y.backward(torch.from_numpy(
        ct if channels_last else np.ascontiguousarray(
            ct.transpose(0, 4, 1, 2, 3))).double())
    return {"dx": _from_port(x.grad, channels_last),
            "params": named_to_flax_flat(
                {n: p.grad for n, p in model.named_parameters()})}


def _rel_err(got: dict, exact: dict) -> float:
    """|got - exact| / |exact| over the gradients of ``exact`` (the input's
    and each parameter's; conv biases that feed an instance norm left
    out: their gradient is zero analytically)."""
    num = den = 0.0
    for k, e in exact.items():
        e = np.asarray(e, np.float64)
        num += float(((np.asarray(got[k], np.float64) - e) ** 2).sum())
        den += float((e ** 2).sum())
    return float(np.sqrt(num / den))


def _grads(d: dict, keep) -> dict:
    return {"dx": d["dx"], **{k: v for k, v in d["params"].items()
                              if keep(k)}}


def _check(name, flax_mod, port_mod, seeds=1, channels_last=False,
           mutable=False, shape=SHAPE, scale=1.0, shift=0.0):
    """The forward bars, then the gradients' distance from the exact ones
    (summed over ``seeds`` inputs): the port's at most ``GRAD_FACTOR`` x
    flax's + ``GRAD_SLACK``."""
    biases_feed_norms = name != "head"
    keep = (lambda k: not (biases_feed_norms and BIAS_BEFORE_NORM.search(k)))
    err = {"port": 0.0, "flax": 0.0}
    fwd = FORWARD_ULPS.get(name, 1.0)
    for seed in range(seeds):
        x = (scale * np.random.default_rng(seed).standard_normal(shape)
             + shift).astype(np.float32)
        want, got, exact = _compare(flax_mod, port_mod, x,
                                    channels_last=channels_last,
                                    mutable=mutable)
        u = (_ulps(got["y"], want["y"]), _ulps(got["y_nograd"], want["y"]))
        assert max(u) <= fwd, (name, seed, u)
        e = _grads(exact, keep)
        err["port"] += _rel_err(_grads(got, keep), e)
        err["flax"] += _rel_err(_grads(want, keep), e)
    assert err["port"] <= GRAD_FACTOR * err["flax"] + GRAD_SLACK * seeds, (
        name, err)
    return want, got


@pytest.mark.parametrize("name", list(MODULES))
def test_module_matches_flax_in_bf16(name):
    make_ref, make_port = MODULES[name]
    _check(name, make_ref(), make_port(), seeds=SEEDS.get(name, 1),
           shape=INPUT.get(name, SHAPE))


class _BatchNorm(nn.Module):
    train: bool

    @nn.compact
    def __call__(self, x):
        return nn.BatchNorm(use_running_average=not self.train,
                            momentum=0.9, epsilon=1e-6, dtype=BF)(x)


class _PortBatchNorm(FlaxNamed):
    def __init__(self, train):
        super().__init__()
        self.child("BatchNorm", BatchNorm(C, 1e-6, 0.9, axis=-1), "bn")
        self.train(train)

    def forward(self, x):
        return self.bn(x)


@pytest.mark.parametrize("train", [False, True])
def test_batch_norm_matches_flax_in_bf16(train):
    """The point net's batch norm (channels last): the batch's or the
    running statistics, then the running ones updated (train mode) as
    flax updates them."""
    want, got = _check("batch_norm", _BatchNorm(train),
                       _PortBatchNorm(train), channels_last=True,
                       mutable=train, shape=(1, 512, 4, C), scale=2.0,
                       shift=0.5)
    for key, v in want["stats"].items():
        np.testing.assert_allclose(got["stats"][key], v, rtol=1e-6,
                                   atol=1e-7, err_msg=key)
