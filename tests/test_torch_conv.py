"""Kernel 3's plain version (pointunet_tpu_torch/ops/conv_cuda.py) against
the reference's Pallas conv in interpret mode, and the port's Conv route
under POINTUNET_FASTCONV=pallas against its F.conv3d route and against the
JAX saliency net.

Tolerances:

* plain vs ``conv3d_3x3_pallas`` (f32): rtol = atol = 2e-5, the
  reference's own bar against XLA's conv (tests/test_conv_pallas.py);
  both sum 27 f32 tap products, in another order;
* bf16: the plain version rounds its f32 sum once, so it lies within one
  bf16 ulp of the f32 result (on the same bf16-representable inputs)
  rounded to bf16;
* the Conv route vs ``F.conv3d`` (f32): 1e-5 absolute and relative, sum
  order only;
* ``SaliencyUNet`` with the route on vs the JAX model at its CPU default:
  atol 3e-4, rtol 1e-4, the bar of tests/test_torch_saliency.py;
* the tensor-core path's packed weight read back through its documented
  index formula: equal (a copy), zeros in the padded columns; the conv
  summed from the packed weight the way the kernel indexes it (stage of
  16 channels and one dz, 9 (dy, dx) taps): within 1e-5 x max |plain| of
  the plain version (f32, sum order only);
* the path choice at the 19 captured shapes of one bf16 ROI forward, one
  f32 window and one bf16 Pancreas CT, and the narrow and deep designs'
  plans (slabs, rows, runs of Cin): exact;
* plain vs ``conv3d_3x3_pallas`` at the head (128 -> 2) and a deep conv
  (256 channels on a small volume): f32 as above; bf16 (inputs
  representable in bf16) within one bf16 ulp of the f32 reference
  rounded to bf16, or 1e-5 x its max where the products cancel (the bar
  chip_smoke.py holds the kernel to: two f32 sums in other orders);
* the deep design's split sum (runs of Cin chunks summed in order, then
  rounded once) from the packed weight: within 1e-5 x max |plain| of the
  plain version in f32.

The CUDA kernel cannot run here; its plain version computes the same
function, and chip_smoke.py holds the kernel to it on the card.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from pointunet_tpu.core.config import brats_saliency_config as jax_cfg
from pointunet_tpu.models.saliency_unet import init_saliency_unet as jax_init
from pointunet_tpu.ops import conv_pallas
from pointunet_tpu_torch.convert import convert_saliency
from pointunet_tpu_torch.core.config import brats_saliency_config
from pointunet_tpu_torch.models import fastconv
from pointunet_tpu_torch.models.fastconv import Conv
from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet
from pointunet_tpu_torch.ops import conv_cuda
from torch_parity import flat_variables

torch.set_num_threads(1)


@pytest.fixture
def interpret(monkeypatch):
    """The reference's Pallas conv in interpret mode, re-jitted so that
    the patched ``pallas_call`` is traced (tests/test_conv_pallas.py)."""
    monkeypatch.setattr(
        conv_pallas.pl, "pallas_call",
        functools.partial(conv_pallas.pl.pallas_call, interpret=True),
    )
    monkeypatch.setattr(
        conv_pallas, "conv3d_3x3_pallas",
        jax.jit(conv_pallas.conv3d_3x3_pallas.__wrapped__,
                static_argnames=("bz", "by")),
    )


def _inputs(rng, shape, cin, cout, batch=None):
    lead = () if batch is None else (batch,)
    x = rng.standard_normal(lead + shape + (cin,)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, cin, cout)) * 0.1).astype(np.float32)
    return x, w


def _to_port(x, w):
    """channels-last (.., Z, Y, X, Cin), DHWIO -> (B, Cin, D, H, W),
    (Cout, Cin, 3, 3, 3) tensors."""
    xt = torch.from_numpy(x if x.ndim == 5 else x[None])
    return (xt.permute(0, 4, 1, 2, 3).contiguous(),
            torch.from_numpy(w.transpose(4, 3, 0, 1, 2).copy()))


def _from_port(y, batched):
    y = y.permute(0, 2, 3, 4, 1).float().numpy()
    return y if batched else y[0]


@pytest.mark.parametrize("shape,cin,cout,batch", [
    ((8, 16, 24), 8, 16, None),
    ((7, 13, 24), 8, 4, None),
    ((5, 9, 16), 16, 8, None),
    ((8, 8, 16), 8, 8, 2),
])
def test_plain_matches_pallas_conv(interpret, shape, cin, cout, batch):
    x, w = _inputs(np.random.default_rng(0 if batch is None else 1), shape,
                   cin, cout, batch=batch)
    if batch is None:
        want = conv_pallas.conv3d_3x3_pallas(jnp.asarray(x), jnp.asarray(w),
                                             bz=4, by=8)
    else:
        want = conv_pallas.conv3d_3x3_pallas_batched(jnp.asarray(x),
                                                     jnp.asarray(w))
    got = conv_cuda.conv3d_3x3(*_to_port(x, w))
    assert got.dtype == torch.float32
    assert got.shape == (batch or 1, cout) + shape
    np.testing.assert_allclose(_from_port(got, batch is not None),
                               np.asarray(want), rtol=2e-5, atol=2e-5)


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """The spacing of bf16 values at |a| (8 significant bits)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def test_plain_bf16_within_one_ulp_of_rounded_f32(interpret):
    x, w = _inputs(np.random.default_rng(2), (6, 10, 16), 16, 8)
    xb, wb = (torch.from_numpy(a).bfloat16() for a in (x, w))
    # the f32 reference on the same bf16-representable inputs, rounded
    want = np.array(conv_pallas.conv3d_3x3_pallas(
        jnp.asarray(xb.float().numpy()), jnp.asarray(wb.float().numpy()),
        bz=4, by=8,
    ))
    want_b = torch.from_numpy(want).bfloat16().float().numpy()
    xt, wt = _to_port(xb.float().numpy(), wb.float().numpy())
    got = conv_cuda.conv3d_3x3(xt.bfloat16(), wt.bfloat16())
    assert got.dtype == torch.bfloat16
    got = _from_port(got, False)
    gap = np.abs(got - want_b)
    assert (gap <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want_b)))).all()


@pytest.mark.parametrize("case", ["bias", "upsample", "head", "no_bias"])
def test_conv_route_matches_fconv(monkeypatch, case):
    cin, cout, up, bias = {
        "bias": (8, 16, 1, True), "upsample": (8, 16, 2, True),
        "head": (16, 2, 1, True), "no_bias": (4, 8, 1, False),
    }[case]
    rng = np.random.default_rng(3)
    conv = Conv(cin, cout, 3, upsample=up, use_bias=bias)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(
            rng.standard_normal(conv.weight.shape).astype(np.float32) * 0.1))
        if bias:
            conv.bias.copy_(torch.from_numpy(
                rng.standard_normal(cout).astype(np.float32)))
    x = torch.from_numpy(
        rng.standard_normal((1, cin, 5, 6, 7)).astype(np.float32))
    calls = []
    plain = conv_cuda.conv3d_3x3_plain
    monkeypatch.setattr(conv_cuda, "conv3d_3x3_plain",
                        lambda *a: calls.append(a) or plain(*a))
    with torch.no_grad():
        want = conv(x)
        assert calls == []
        monkeypatch.setenv("POINTUNET_FASTCONV", "pallas")
        got = conv(x)
    assert len(calls) == 1
    assert got.shape == want.shape == (1, cout, 5 * up, 6 * up, 7 * up)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_route_only_for_eligible_convs(monkeypatch):
    monkeypatch.setenv("POINTUNET_FASTCONV", "pallas")
    calls = []
    monkeypatch.setattr(fastconv, "conv3d_3x3",
                        lambda *a: calls.append(a) or a[0])
    x = torch.zeros(1, 4, 6, 6, 6)
    with torch.no_grad():
        for conv in (Conv(4, 4, 3, strides=2), Conv(4, 4, 3, kernel_dilation=3),
                     Conv(4, 4, 1), Conv(4, 4, (1, 9, 9))):
            conv(x)
        assert calls == []
        Conv(4, 4, 3)(x)
    assert len(calls) == 1


@pytest.mark.parametrize("value,mode", [
    ("pallas", "pallas"), ("", "off"), ("off", "off"), ("all", "all"),
    ("1", "all"), ("fold1", "fold1"), ("k9", "k9"), ("0", "off"),
    ("tpu", "off"), ("FOLD1", "off"), ("pallas ", "off"),
])
def test_decomposition_mode(monkeypatch, value, mode):
    """The reference's modes (``pointunet_tpu/models/fastconv.py:46-64``):
    ``all``/``1``, ``fold1``, ``k9`` and ``pallas`` select their routes;
    unset, ``off``, ``0`` and any other value leave them off on every
    device."""
    monkeypatch.setenv("POINTUNET_FASTCONV", value)
    assert fastconv._decomposition_mode() == mode


def test_wrapper_plain_on_cpu_and_never_falls_back_elsewhere():
    x = torch.zeros(1, 2, 3, 4, 5)
    w = torch.zeros(3, 2, 3, 3, 3)
    before = conv_cuda.LAUNCHES
    assert conv_cuda.conv3d_3x3(x, w).shape == (1, 3, 3, 4, 5)
    assert conv_cuda.LAUNCHES == before
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        conv_cuda.conv3d_3x3(x.to("meta"), w.to("meta"))
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        conv_cuda.conv3d_3x3(x.half(), w.half())
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        conv_cuda.conv3d_3x3(x, w.bfloat16())
    with pytest.raises(ValueError, match="Cout, Cin, 3, 3, 3"):
        conv_cuda.conv3d_3x3(x, w[:, :, :1])
    assert conv_cuda.LAUNCHES == before


def test_saliency_unet_with_route_matches_reference(monkeypatch):
    model, variables = jax_init(jax.random.PRNGKey(0), jax_cfg(sa_gate_stride=1))
    x = np.random.default_rng(4).standard_normal(
        (1, 16, 32, 32, 4)).astype(np.float32)
    want = np.asarray(
        jax.jit(lambda v: model.apply(variables, v, train=False))(
            jnp.asarray(x))
    )
    cfg = brats_saliency_config(sa_gate_stride=1)
    port = SaliencyUNet(cfg)
    port.load_state_dict(convert_saliency(flat_variables(variables), cfg))
    calls = []
    real = fastconv.conv3d_3x3
    monkeypatch.setattr(fastconv, "conv3d_3x3",
                        lambda *a: calls.append(a) or real(*a))
    # the route is set for the port's forward only: the reference with the
    # variable set would take its depth decomposition on the CPU
    monkeypatch.setenv("POINTUNET_FASTCONV", "pallas")
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    monkeypatch.delenv("POINTUNET_FASTCONV")
    assert len(calls) == 19          # the net's eligible convs
    np.testing.assert_allclose(
        got.permute(0, 2, 3, 4, 1).numpy(), want, atol=3e-4, rtol=1e-4
    )


# the 19 eligible convs of one saliency forward at the serve ROI
# (1, 4, 160, 208, 192): (Cin, Cout, W)
ROI_CONVS = (
    [(4, 16, 192), (16, 16, 192), (16, 16, 192), (32, 32, 96), (32, 32, 96),
     (64, 64, 48), (64, 64, 48), (128, 128, 24), (128, 128, 24),
     (256, 256, 12), (256, 256, 12), (16, 64, 192), (32, 64, 96),
     (128, 128, 48), (128, 128, 48), (64, 64, 192), (64, 64, 192),
     (128, 64, 192), (128, 2, 192)]
)


@pytest.mark.parametrize("cin,cout", [(32, 2), (16, 64), (48, 20), (128, 2),
                                      (32, 128), (16, 256)])
def test_packed_weight_reads_back(cin, cout):
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (cout, cin, 3, 3, 3)).astype(np.float32)).bfloat16()
    wp = conv_cuda.pack_weight(w)
    np_ = -(-cout // 8) * 8
    assert wp.shape == (cin // 16, 27, np_, 16) and wp.dtype == w.dtype
    back = torch.empty_like(w)
    for o in range(cout):
        for c in range(cin):
            for dz in range(3):
                for dy in range(3):
                    for dx in range(3):
                        back[o, c, dz, dy, dx] = wp[c // 16,
                                                    dz * 9 + dy * 3 + dx,
                                                    o, c % 16]
    assert torch.equal(back, w)
    assert not wp[:, :, cout:].any()


def _xf_logical(wpx: torch.Tensor, cout: int) -> torch.Tensor:
    """``pack_weight_xf``'s blocks read back through its documented index
    formula: (Cin / 8, 27, T * BN, 8), [c // 8, dz * 9 + t9, o, c % 8]."""
    chunks, _, nt, _, blk = wpx.shape
    bn = blk // 8
    out = torch.empty((chunks, 27, nt * bn, 8), dtype=wpx.dtype)
    for n in range(bn):
        for k in range(8):
            e = ((n // 8) * 2 + k // 4) * 32 + (n % 8) * 4 + k % 4
            for t in range(nt):
                out[:, :, t * bn + n, k] = wpx[:, :, t, :, e].reshape(
                    chunks, 27)
    return out


@pytest.mark.parametrize("cin,cout", [(32, 2), (16, 64), (48, 20),
                                      (8, 128)])
def test_packed_xf_weight_reads_back(cin, cout):
    """The 3xTF32 kernel's weight layout (its packing kernel's plain
    form) holds w at the documented places and zeros past Cout, and its
    TF32 hi and lo parts add back to it."""
    w = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (cout, cin, 3, 3, 3)).astype(np.float32))
    wpx = conv_cuda.pack_weight_xf(w)
    bn = conv_cuda.xf_tile_n(cout)
    nt = -(-cout // bn)
    assert wpx.shape == (cin // 8, 3, nt, 9, bn * 8)
    logical = _xf_logical(wpx, cout)
    back = logical[:, :, :cout].permute(2, 0, 3, 1).reshape(cout, cin, 27)
    assert torch.equal(back, w.reshape(cout, cin, 27))
    assert not logical[:, :, cout:].any()
    hi, lo = conv_cuda.split_tf32(wpx)
    for part in (hi, lo):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    assert float((hi + lo - wpx).abs().max()) <= 2.0 ** -21 * float(
        wpx.abs().max())


def _conv_from_packed(x, wp, cout, runs=1):
    """The tensor-core kernels' sum in plain torch from their packed
    weight (``pack_weight``'s for bf16, ``pack_weight_xf``'s for f32):
    stages of 16 (bf16) or 8 (f32) input channels and one input plane dz,
    each the 9 (dy, dx) taps' products of the shifted tile with the (ck,
    N) weight block. f32 follows the 3xTF32 kernel: the operands split into TF32 hi
    and lo, a stage's 27 x 3 products (lo x hi, hi x lo, hi x hi) summed
    from zero and added to the running sum, the channel chunks in
    ``runs`` contiguous runs whose sums are added in order."""
    b, cin, d, h, wd = x.shape
    f32 = wp.ndim == 5               # pack_weight_xf's blocks
    if f32:
        wp = _xf_logical(wp, cout)
    ck = wp.shape[-1]
    xp = torch.nn.functional.pad(x.float(), (1, 1, 1, 1, 1, 1))
    if f32:
        (xh, xl), (wh, wl) = conv_cuda.split_tf32(xp), conv_cuda.split_tf32(wp)
    chunks = cin // ck
    per = -(-chunks // runs)
    out = torch.zeros((b, wp.shape[2], d, h, wd))
    for c0 in range(0, chunks, per):
        acc = torch.zeros_like(out)
        for cc in range(c0, min(chunks, c0 + per)):
            for dz in range(3):
                part = torch.zeros_like(out)
                for t9 in range(9):
                    dy, dx = divmod(t9, 3)
                    sl = (slice(None), slice(cc * ck, (cc + 1) * ck),
                          slice(dz, dz + d), slice(dy, dy + h),
                          slice(dx, dx + wd))
                    tap = dz * 9 + t9
                    if f32:
                        for xa, wb in ((xl, wh), (xh, wl), (xh, wh)):
                            part += torch.einsum("bcdhw,nc->bndhw", xa[sl],
                                                 wb[cc, tap])
                    else:
                        part += torch.einsum("bcdhw,nc->bndhw", xp[sl],
                                             wp[cc, tap].float())
                acc += part
        out += acc
    return out[:, :cout]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("cin,cout,shape", [
    (16, 16, (4, 6, 8)), (32, 2, (3, 5, 12)), (32, 20, (5, 4, 6)),
])
def test_packed_conv_matches_plain(cin, cout, shape, dtype):
    """The sum from the packed weight, indexed as the kernel indexes it,
    within 1e-5 x max |plain| of the plain version (f32 sum order; for
    f32 also the dropped lo x lo products, ~2^-22 relative)."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal(
        (1, cin) + shape).astype(np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((cout, cin, 3, 3, 3)) * 0.1).astype(np.float32))
    if dtype == torch.bfloat16:
        want = conv_cuda.conv3d_3x3_plain(x, w.bfloat16().float())
        got = _conv_from_packed(x, conv_cuda.pack_weight(w.bfloat16()), cout)
    else:
        want = conv_cuda.conv3d_3x3_plain(x, w)
        got = _conv_from_packed(x, conv_cuda.pack_weight_xf(w), cout)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


# every distinct (Cin, Cout) of the 19 eligible convs that the f32 path
# runs on the tensor cores
XF_PAIRS = [(16, 16), (32, 32), (64, 64), (128, 128), (256, 256), (16, 64),
            (32, 64), (128, 64), (128, 2)]


@pytest.mark.parametrize("cin,cout", XF_PAIRS)
def test_3xtf32_sum_meets_the_f32_bar(interpret, cin, cout):
    """The 3xTF32 kernel's arithmetic (``_conv_from_packed`` on its
    packed weight, in 2 runs where Cin allows) at the captured channel
    counts on a (4, 8, 8) volume: within 2e-5 x max(1, max |ref|) of the
    f64 conv and of the Pallas kernel in interpret mode (the reference's
    f32 bar), where one TF32 product (hi x hi) is not."""
    x, w = _inputs(np.random.default_rng(7), (4, 8, 8), cin, cout)
    xt, wt = _to_port(x, w)
    exact = torch.nn.functional.conv3d(xt.double(), wt.double(), padding=1)
    pallas = torch.from_numpy(np.asarray(conv_pallas.conv3d_3x3_pallas(
        jnp.asarray(x), jnp.asarray(w), bz=4, by=8))).permute(3, 0, 1, 2)[None]
    got = _conv_from_packed(xt, conv_cuda.pack_weight_xf(wt), cout,
                            runs=min(2, cin // 8))
    for ref in (exact, pallas.double()):
        bar = 2e-5 * max(1.0, float(ref.abs().max()))
        assert float((got.double() - ref).abs().max()) <= bar
    # one TF32 product a term: every operand rounded to 11 significant bits
    xh, wh = conv_cuda.split_tf32(xt)[0], conv_cuda.split_tf32(wt)[0]
    one = torch.nn.functional.conv3d(xh.double(), wh.double(), padding=1)
    bar = 2e-5 * max(1.0, float(exact.abs().max()))
    assert float((one - exact).abs().max()) > 5 * bar


def _rna_reference(x: np.ndarray) -> np.ndarray:
    """TF32 rounding of normal f32 values in f64 arithmetic: 11
    significant bits, ties away from zero."""
    m, e = np.frexp(x.astype(np.float64))
    s = m * 2.0 ** 11
    return np.ldexp(np.sign(s) * np.floor(np.abs(s) + 0.5), e - 11)


def test_split_tf32_rounds_as_cvt_rna():
    u = 2.0 ** -23
    cases = [                          # (x, hi) with x exact in f32
        (1.0, 1.0), (0.0, 0.0), (2.0 ** -126, 2.0 ** -126),
        (1 + 2 ** -11, 1 + 2 ** -10),           # a tie: away from zero
        (-(1 + 2 ** -11), -(1 + 2 ** -10)),
        (1 + 3 * 2 ** -11, 1 + 2 ** -9),        # a tie: away from zero
        (1 + 2 ** -11 - u, 1.0),                # just below the tie
        (1 + 2 ** -11 + u, 1 + 2 ** -10),
        (2 - u, 2.0),                           # carries into the exponent
        (-3.0e38, float(_rna_reference(np.float32([-3.0e38]))[0])),
    ]
    x = torch.tensor([c[0] for c in cases], dtype=torch.float32)
    hi, lo = conv_cuda.split_tf32(x)
    assert hi.tolist() == [c[1] for c in cases]
    rest = (x.double() - hi.double()).numpy()      # exact in f32
    want_lo = np.where(rest == 0, 0.0, _rna_reference(rest))
    np.testing.assert_array_equal(lo.double().numpy(), want_lo)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    # the sign of zero survives
    assert torch.signbit(conv_cuda.split_tf32(torch.tensor([-0.0]))[0]).item()


@settings(max_examples=300, deadline=None, derandomize=True)
@given(st.lists(st.floats(min_value=-2.0 ** 127, max_value=2.0 ** 127,
                          width=32, allow_subnormal=False),
                min_size=1, max_size=64))
def test_split_tf32_random(values):
    x = torch.tensor(values, dtype=torch.float32)
    hi, lo = conv_cuda.split_tf32(x)
    xn = x.numpy()
    np.testing.assert_array_equal(hi.double().numpy(), _rna_reference(xn))
    rest = (x.double() - hi.double()).numpy()      # exact in f32
    normal = np.abs(rest) >= 2.0 ** -126
    np.testing.assert_array_equal(lo.double().numpy()[normal],
                                  _rna_reference(rest[normal]))
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert not (lo.view(torch.int32) & 0x1FFF).any()
    err = (hi.double() + lo.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


def test_conv_splits_at_the_deep_shapes():
    """Deep convs split their Cin chunks into runs (none empty); the
    large ones do not."""
    for cin, cout, vol, want in (
            (256, 256, (4, 10, 10), 8), (128, 128, (8, 20, 20), 6),
            (64, 64, (16, 40, 40), 2), (128, 128, (16, 40, 40), 1),
            (128, 64, (64, 160, 160), 1), (128, 2, (64, 160, 160), 1)):
        splits = conv_cuda.conv_splits(1, cin, cout, *vol)
        assert splits == want
        per = -(-(cin // 8) // splits)
        assert (splits - 1) * per < cin // 8


def test_conv_path_at_the_captured_shapes():
    assert len(ROI_CONVS) == 19
    paths = [conv_cuda.conv_path(torch.bfloat16, cin, cout, wd)
             for cin, cout, wd in ROI_CONVS]
    assert paths[0] == "cuda_cores"                  # the init conv, 4 -> 16
    # the coarse levels (W <= 64: the L2, L3, L4 blocks, up_c5, up_c4) on
    # the deep design, the head (128 -> 2) on the narrow one
    deep = [i for i, (_, _, wd) in enumerate(ROI_CONVS) if wd <= 64]
    assert deep == [5, 6, 7, 8, 9, 10, 13, 14]
    assert [paths[i] for i in deep] == ["deep_tensor_cores"] * 8
    assert paths[18] == "narrow_tensor_cores"
    assert [p for i, p in enumerate(paths)
            if i not in deep + [0, 18]] == ["tensor_cores"] * 9
    # the f32 window (1, 4, 64, 160, 160): every conv but the init conv and
    # the head on the tensor cores with 3xTF32 products, the head on the
    # narrow design's CUDA cores
    paths = [conv_cuda.conv_path(torch.float32, cin, cout, wd * 160 // 192)
             for cin, cout, wd in ROI_CONVS]
    assert paths[0] == "cuda_cores"
    assert paths[1:18] == ["tensor_cores_3xtf32"] * 17
    assert paths[18] == "narrow_cuda_cores"
    # the head's kernel takes whole 8-element vectors of W and Cout <= 2
    assert conv_cuda.conv_path(torch.bfloat16, 128, 2, 196) == "tensor_cores"
    assert conv_cuda.conv_path(torch.bfloat16, 128, 4, 192) == "tensor_cores"
    assert conv_cuda.conv_path(torch.bfloat16, 16, 16, 13) == "cuda_cores"
    assert conv_cuda.conv_path(torch.bfloat16, 24, 16, 12) == "cuda_cores"
    assert conv_cuda.conv_path(torch.float32, 16, 16, 13) == "cuda_cores"
    assert conv_cuda.conv_path(torch.float32, 12, 16, 12) == "cuda_cores"


# the three contracts' first conv input (B, Cin, D, H, W), dtype and the
# path of each of the 19 convs (the levels of ROI_CONVS: W / 192 of the
# input's W; Pancreas has one CT channel)
CONTRACTS = {
    "bf16 ROI": ((1, 4, 160, 208, 192), torch.bfloat16),
    "f32 window": ((1, 4, 64, 160, 160), torch.float32),
    "bf16 Pancreas": ((1, 1, 160, 256, 256), torch.bfloat16),
}
WANT_PATHS = {
    "bf16 ROI": ["cuda_cores"] + ["tensor_cores"] * 4
    + ["deep_tensor_cores"] * 6 + ["tensor_cores"] * 2
    + ["deep_tensor_cores"] * 2 + ["tensor_cores"] * 3
    + ["narrow_tensor_cores"],
    "f32 window": ["cuda_cores"] + ["tensor_cores_3xtf32"] * 17
    + ["narrow_cuda_cores"],
    # W = 64 and 32 fill the wide design's 32-column tiles: only L4 (W =
    # 16) takes the deep design
    "bf16 Pancreas": ["cuda_cores"] + ["tensor_cores"] * 8
    + ["deep_tensor_cores"] * 2 + ["tensor_cores"] * 7
    + ["narrow_tensor_cores"],
}


def _contract_convs(name):
    """(Cin, Cout, (D, H, W)) of the 19 convs of a contract's forward."""
    (_, c0, d, h, wd), _ = CONTRACTS[name]
    out = []
    for i, (cin, cout, w192) in enumerate(ROI_CONVS):
        level = {192: 0, 96: 1, 48: 2, 24: 3, 12: 4}[w192]
        out.append((c0 if i == 0 else cin, cout,
                    (d >> level, h >> level, wd >> level)))
    return out


@pytest.mark.parametrize("name,index", [
    (name, i) for name in CONTRACTS for i in range(19)])
def test_conv_path_by_contract(name, index):
    """Each conv of each contract takes its design: the head the narrow
    one, the coarse bf16 levels (W <= 64, not a multiple of 32) the deep
    one."""
    cin, cout, (_, _, wd) = _contract_convs(name)[index]
    dtype = CONTRACTS[name][1]
    assert conv_cuda.conv_path(dtype, cin, cout, wd) == WANT_PATHS[name][index]


@pytest.mark.parametrize("dtype,cout,shape", [
    (torch.bfloat16, 2, (160, 208, 192)), (torch.bfloat16, 2, (160, 256, 256)),
    (torch.bfloat16, 1, (1, 10, 32)), (torch.bfloat16, 2, (13, 20, 40)),
    (torch.bfloat16, 2, (7, 9, 16)), (torch.float32, 2, (64, 160, 160)),
    (torch.float32, 4, (37, 9, 30)), (torch.float32, 8, (5, 40, 32)),
    (torch.float32, 3, (2, 3, 4))])
def test_narrow_slabs_cover_every_plane(dtype, cout, shape):
    """The narrow designs' slabs cover the D output planes once, in order,
    none empty: 10 / CO planes a slab in f32, the slab the wave model
    picks in bf16 (the whole depth where one slab a tile column already
    gives a block to each SM, as at the serve ROI)."""
    d, h, wd = shape
    slabs = conv_cuda.narrow_slabs(dtype, 1, cout, d, h, wd)
    nz = conv_cuda.narrow_planes(dtype, 1, cout, d, h, wd)
    if dtype == torch.float32:
        assert nz == 10 // {2: 2, 3: 4, 4: 4, 8: 8}[cout]
    elif shape == (160, 208, 192):
        assert nz == 160               # 126 tile columns: one block each
    assert [z for z0, z1 in slabs for z in range(z0, z1)] == list(range(d))
    assert all(z1 > z0 for z0, z1 in slabs)
    assert all(z1 - z0 == nz for z0, z1 in slabs[:-1])
    assert len(slabs) == -(-d // nz)


# the deep design's convs of both bf16 contracts, and tc_splits and
# deep_tile at them: (splits, (BN, M, yb))
DEEP_PLANS = {
    ("bf16 ROI", 5): (1, (64, 512, 9)), ("bf16 ROI", 7): (2, (128, 256, 9)),
    ("bf16 ROI", 9): (6, (128, 256, 13)), ("bf16 ROI", 13): (1, (128, 256, 5)),
    ("bf16 Pancreas", 9): (3, (128, 256, 8)),
}
DEEP_SHAPES = list(DEEP_PLANS)


@pytest.mark.parametrize("name,index", DEEP_SHAPES)
def test_deep_plan_at_the_captured_shapes(name, index):
    """The deep design's plan at its convs of both bf16 contracts:
    its rows fit the M tile and cover H; the split runs cover every Cin
    chunk once, in order, none empty; only a grid of fewer tiles than SMs
    splits, and its blocks stay within one an SM."""
    cin, cout, (d, h, wd) = _contract_convs(name)[index]
    assert conv_cuda.conv_path(torch.bfloat16, cin, cout,
                               wd) == "deep_tensor_cores"
    splits = conv_cuda.tc_splits(1, cin, cout, d, h, wd)
    bn, m, yb = conv_cuda.deep_tile(cout, h, wd)
    assert (splits, (bn, m, yb)) == DEEP_PLANS[(name, index)]
    assert (yb - 1) * (wd + 2) + wd <= m
    y_tiles = -(-h // yb)
    assert (y_tiles - 1) * yb < h <= y_tiles * yb
    chunks = cin // 16
    per = -(-chunks // splits)
    runs = [list(range(k * per, min(chunks, (k + 1) * per)))
            for k in range(splits)]
    assert [c for run in runs for c in run] == list(range(chunks))
    assert all(runs)
    tiles = d * y_tiles * -(-cout // bn)
    if tiles >= conv_cuda.SMS:
        assert splits == 1
    assert tiles * splits <= max(tiles, conv_cuda.SMS)


@pytest.mark.parametrize("dtype,cin,cout,shape", [
    (torch.float32, 128, 2, (5, 6, 16)), (torch.bfloat16, 128, 2, (5, 6, 16)),
    (torch.float32, 256, 32, (6, 8, 12)), (torch.bfloat16, 256, 32, (6, 8, 12)),
])
def test_plain_matches_pallas_at_the_new_paths(interpret, dtype, cin, cout,
                                               shape):
    """The plain version against the reference's Pallas conv at a head-like
    conv and a deep one (see the module docstring for the bars)."""
    x, w = _inputs(np.random.default_rng(8), shape, cin, cout)
    if dtype == torch.bfloat16:
        x, w = (torch.from_numpy(a).bfloat16().float().numpy() for a in (x, w))
    want = np.array(conv_pallas.conv3d_3x3_pallas(jnp.asarray(x),
                                                  jnp.asarray(w), bz=4, by=8))
    xt, wt = _to_port(x, w)
    got = conv_cuda.conv3d_3x3(xt.to(dtype), wt.to(dtype))
    assert got.dtype == dtype and got.shape == (1, cout) + shape
    got = _from_port(got, False)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    want_b = torch.from_numpy(want).bfloat16().float().numpy()
    ulp = _bf16_ulp(np.maximum(np.abs(got), np.abs(want_b)))
    bar = np.maximum(ulp, 1e-5 * np.abs(want_b).max())
    assert (np.abs(got - want_b) <= bar).all()


@pytest.mark.parametrize("cin,cout,runs", [(64, 64, 2), (128, 32, 3),
                                           (256, 16, 6)])
def test_deep_split_sum_matches_plain(cin, cout, runs):
    """The deep design's arithmetic from its packed weight (pack_weight),
    its Cin chunks in ``runs`` contiguous runs summed in order: within
    1e-5 x max |plain| of the plain version (f32 sum order only)."""
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal(
        (1, cin, 3, 4, 6)).astype(np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((cout, cin, 3, 3, 3)) * 0.1).astype(np.float32))
    want = conv_cuda.conv3d_3x3_plain(x, w.bfloat16().float())
    got = _conv_from_packed(x, conv_cuda.pack_weight(w.bfloat16()), cout,
                            runs=runs)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
