"""Port saliency-net training (pointunet_tpu_torch/train/saliency.py and
what it runs: the saliency losses, the sampler, the volume utilities, the
loaders, UNet3D, bilinear_upsample_3d, the train_attention CLI) against
the reference, on the CPU at small sizes.

Inputs are made with numpy from a seed and fed to both sides; weights go
through ``convert_saliency``/``convert_saliency_train_state``. The nets
run at (16, 32, 32) with ``base_filter`` 4 (c1, c2 and CFE keep their
fixed widths). Tolerances (the port in f32 unless named):

* losses: values within 1e-6 relative, gradients within 1e-5 relative
  (the same terms, summed in another order);
* data (volume utilities, sampler, loaders): bit for bit;
* ``lr_at``: equal to optax's schedule (both multiply the ratios in f32);
* UNet3D logits: atol 3e-4, rtol 1e-4, as tests/test_torch_saliency.py
  states for SaliencyUNet (GroupNorm's variance in another form, conv
  sums in another order); ``bilinear_upsample_3d``: 1e-6;
* one train step (batch 2, the port with remat on), its gradients held
  in f64 on both sides from the same f32 weights and inputs (the port's
  model a copy in f64): every gradient within 2e-6 x that leaf's own
  largest gradient (``GRAD64_BAR``). Both nets cast their logits to f32
  before the loss (the reference's head ``astype(jnp.float32)``, the
  port's ``.float()``), so the f64 gradients carry the f32 loss's
  rounding: measured worst 4.6e-7 of a leaf's own largest (a GroupNorm
  scale of the spatial attention), 2e-7 or less elsewhere; the losses are
  equal to the last digit. Conv biases that feed an instance norm have a
  zero gradient analytically: both sides stay below 1e-12 x the model's
  largest gradient |g|max there (``ZERO_GRAD_BAR``; measured 2.5e-15).
  The f32 step itself: loss within 1e-5 relative of the reference's f64
  and f32 losses;
* the updated parameters after that f32 step, and after a second step
  from the reference's own state after step 1 (its momentum trace carried
  by ``convert_saliency_train_state``), against the reference's f32 step
  (its ``train_step``'s parts, with remat off and the micro-batch loop in
  Python: the jitted ``lax.scan`` takes ~60 s a step on the CPU): within
  lr x 1e-2 x |g|max + 1e-7 (``GRAD_BAR``), the f32 gradient's spread
  through one SGD step plus f32 rounding of the weights. In f32 the
  gradient at this patch is ill-conditioned (the instance norms of the
  deep scales see 4 voxels at the deepest): with the suite's weights (its
  rbg PRNG), moving the input by 2^-22 relative (two ulps) moves the
  port's own f32 gradient by 4.4e-3 x |g|max; against the f64 gradient
  the port's f32 one is off by 4.6e-3 x |g|max and the reference's own
  f32 one by 2.0e-3 (with threefry weights: 3.5e-4 and 5.4e-4). The
  momentum term (0.9 x lr x the trace) is ~90 times that bar;
* remat on against off in the port: gradients within 1e-6 x |g|max;
* sliding-window predictions (plain, dynamic shape, sagittal with flip,
  multi-view): probabilities within 1e-4 absolute (the logit bar through
  a softmax);
* the checkpoint round trip: resumed training bit-equal.
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util

from pointunet_tpu.core.config import brats_saliency_config as jax_cfg
from pointunet_tpu.data import loader as jax_loader
from pointunet_tpu.data import sampler as jax_sampler
from pointunet_tpu.data import volume as jax_volume
from pointunet_tpu.models import losses as jax_losses
from pointunet_tpu.models.saliency_unet import init_saliency_unet as jax_init
from pointunet_tpu.models.upsample import bilinear_upsample_3d as jax_upsample
from pointunet_tpu.train.saliency import SaliencyTrainer as JaxTrainer
from pointunet_tpu_torch.cli import train_attention
from pointunet_tpu_torch.convert import (
    convert_leaves,
    convert_saliency,
    convert_saliency_train_state,
    convert_variables,
)
from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
from pointunet_tpu_torch.core.config import brats_saliency_config
from pointunet_tpu_torch.data import loader, nifti, sampler, volume
from pointunet_tpu_torch.models import losses
from pointunet_tpu_torch.models import saliency_unet
from pointunet_tpu_torch.models.upsample import bilinear_upsample_3d
from pointunet_tpu_torch.ops import conv_cuda
from pointunet_tpu_torch.train.saliency import (
    SaliencyTrainer,
    SaliencyTrainState,
    decay_split,
    make_optimizer,
)
from torch_parity import flat_variables, named_to_flax_flat
from util_synthetic import make_brats_case

torch.set_num_threads(1)

TINY = dict(base_filter=4, patch_size=(16, 32, 32),
            inference_patch_size=(16, 32, 32), xstep=8, ystep=16, zstep=16)
# the module docstring has the measurements behind these bars:
# f64 gradients against the reference's, as a share of each leaf's own
# largest; the zero gradients, as a share of the model's largest; the f32
# step's spread, as a share of the model's largest gradient
GRAD64_BAR = 2e-6
ZERO_GRAD_BAR = 1e-12
GRAD_BAR = 1e-2
# conv biases that feed an instance norm: zero gradient analytically
BIAS_BEFORE_NORM = re.compile(
    r"(ConvNormRelu_\d+/Conv_0|SpatialAttention3D_0/Conv_\d+)/bias$"
)


def _batch(rng, b=2, patch=(16, 32, 32)):
    """A sampler-layout batch: (B, D, H, W, 4) images, weights, labels with
    a tumour box."""
    img = rng.standard_normal((b,) + patch + (4,)).astype(np.float32)
    w = (rng.uniform(size=(b,) + patch) < 0.8).astype(np.float32)
    lab = np.zeros((b,) + patch, np.int32)
    lab[:, 4:12, 8:24, 8:24] = 1
    img[..., 0] += 2.0 * lab
    return img, w, lab


def _flat_state(state) -> dict:
    """A reference SaliencyTrainState -> the flat dict
    convert_saliency_train_state takes."""
    flat = {f"params/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(state.params, sep="/").items()}
    trace, sched = state.opt_state[1]
    flat.update({f"trace/{k}": np.asarray(v) for k, v in
                 traverse_util.flatten_dict(trace.trace, sep="/").items()})
    flat["count"] = np.asarray(sched.count)
    flat["step"] = np.asarray(state.step)
    return flat


def _port_state(flat, cfg, attention=True):
    trainer = SaliencyTrainer(cfg, device="cpu", attention=attention)
    state = trainer.init_state()
    state.load_state_dict(convert_saliency_train_state(flat, state.model))
    return trainer, state


def _params(state) -> dict:
    return named_to_flax_flat(
        {n: p.detach() for n, p in state.model.named_parameters()}
    )


# ------------------------------------------------------------------ #
# (a) losses


def _probs(rng, v=300, c=2):
    z = rng.standard_normal((v, c)).astype(np.float32) * 2
    return np.exp(z) / np.exp(z).sum(-1, keepdims=True)


def _mixed_target(rng, shape, c=2):
    a = np.eye(c, dtype=np.float32)[rng.integers(0, c, shape)]
    b = np.eye(c, dtype=np.float32)[rng.integers(0, c, shape)]
    return 0.3 * a + 0.7 * b


@pytest.mark.parametrize("name", [
    "soft_dice", "generalised_dice_loss", "soft_dice_mixup",
    "saliency_dice_loss", "saliency_dice_loss_mixup",
])
def test_saliency_losses_match_reference(rng, name):
    weight = (rng.uniform(size=300) < 0.8).astype(np.float32)
    if name == "soft_dice":
        probs, lab = _probs(rng), rng.integers(0, 2, 300)
        for w in (weight, None):
            want = jax_losses.soft_dice(
                jnp.asarray(probs), jnp.asarray(lab),
                None if w is None else jnp.asarray(w))
            got = losses.soft_dice(
                torch.from_numpy(probs), torch.from_numpy(lab),
                None if w is None else torch.from_numpy(w))
            np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        return
    if name == "generalised_dice_loss":
        # class 1 of 3 absent: it takes the largest weight of the others
        probs, lab = _probs(rng, c=3), 2 * rng.integers(0, 2, 300)
        want = jax_losses.generalised_dice_loss(
            jnp.asarray(probs), jnp.asarray(lab), jnp.asarray(weight))
        got = losses.generalised_dice_loss(
            torch.from_numpy(probs), torch.from_numpy(lab),
            torch.from_numpy(weight))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        return
    if name == "soft_dice_mixup":
        probs, target = _probs(rng), _mixed_target(rng, 300)
        want = jax_losses.soft_dice_mixup(
            jnp.asarray(probs), jnp.asarray(target), jnp.asarray(weight))
        got = losses.soft_dice_mixup(
            torch.from_numpy(probs), torch.from_numpy(target),
            torch.from_numpy(weight))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
        return
    # the batch losses: port logits (B, C, D, H, W), reference channels
    # last; the value and the gradient with respect to the logits
    logits = rng.standard_normal((2, 2, 4, 6, 8)).astype(np.float32) * 2
    w = (rng.uniform(size=(2, 4, 6, 8)) < 0.8).astype(np.float32)
    if name == "saliency_dice_loss":
        lab = (rng.uniform(size=(2, 4, 6, 8)) < 0.3).astype(np.int32)
        jl, tl = jnp.asarray(lab), torch.from_numpy(lab)
    else:
        target = _mixed_target(rng, (2, 4, 6, 8))
        jl = jnp.asarray(target)
        tl = torch.from_numpy(np.moveaxis(target, -1, 1).copy())
    jfn = getattr(jax_losses, name)
    want, want_g = jax.value_and_grad(
        lambda z: jfn(z, jnp.asarray(w), jl)
    )(jnp.asarray(np.moveaxis(logits, 1, -1)))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = getattr(losses, name)(z, torch.from_numpy(w), tl)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    want_g = np.moveaxis(np.asarray(want_g), -1, 1)
    np.testing.assert_allclose(z.grad.numpy(), want_g, rtol=1e-5,
                               atol=1e-5 * np.abs(want_g).max())


# ------------------------------------------------------------------ #
# (b) data, bit for bit


def test_volume_functions_match_reference(rng):
    vol = rng.standard_normal((12, 10, 9)).astype(np.float32)
    vol[:3] = 0
    vol[:, :, -2:] = 0
    for fn in ("intensity_normalize_nonzero", "intensity_normalize_full",
               "rescale_pancreas_hu"):
        arg = vol * 300 if fn == "rescale_pancreas_hu" else vol
        np.testing.assert_array_equal(getattr(volume, fn)(arg),
                                      getattr(jax_volume, fn)(arg))
    np.testing.assert_array_equal(
        volume.intensity_normalize_nonzero(np.zeros((3, 3))),
        jax_volume.intensity_normalize_nonzero(np.zeros((3, 3))))
    for margin in (0, 2, 5):
        assert (volume.nonzero_bbox(vol != 0, margin)
                == jax_volume.nonzero_bbox(vol != 0, margin))
    assert volume.nonzero_bbox(np.zeros((4, 5))) == ((0, 4), (0, 5))
    mods = np.stack([vol, np.roll(vol, 2, axis=0)])
    lab = (vol > 1).astype(np.int32)
    for label in (lab, None):
        got = volume.crop_brain_region(mods, label, margin=1)
        want = jax_volume.crop_brain_region(mods, label, margin=1)
        for g, w in zip(got, want):
            if w is None or isinstance(w, tuple):
                assert g == w
            else:
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    for center, patch in (((6, 5, 4), (4, 6, 8)), ((0, 9, 2), (7, 5, 12)),
                          ((11, 0, 8), (16, 16, 16))):
        got = volume.extract_roi(vol, center, patch)
        np.testing.assert_array_equal(
            got, jax_volume.extract_roi(vol, center, patch))
        np.testing.assert_array_equal(
            volume.insert_roi(vol, got * 2, center),
            jax_volume.insert_roi(vol, got * 2, center))


@pytest.mark.parametrize("crop,with_label", [(True, True), (False, False)])
def test_load_brats_case_matches_reference(tmp_path, rng, crop, with_label):
    case_dir, _ = make_brats_case(str(tmp_path), "case_a", (24, 20, 14), rng)
    got_rec, got_meta = loader.load_brats_case(case_dir, with_label, crop)
    want_rec, want_meta = jax_loader.load_brats_case(case_dir, with_label,
                                                     crop)
    for field in ("image", "weight", "label"):
        g, w = getattr(got_rec, field), getattr(want_rec, field)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert set(got_meta) == set(want_meta)
    for key, w in want_meta.items():
        if isinstance(w, np.ndarray):
            np.testing.assert_array_equal(got_meta[key], w)
        else:
            assert got_meta[key] == w
    assert loader.find_brats_cases(str(tmp_path)) == \
        jax_loader.find_brats_cases(str(tmp_path))


def _write_pancreas(root, rng, ids=("0001", "0002"), shape=(12, 10, 8)):
    ct, lab = os.path.join(root, "ct"), os.path.join(root, "label")
    os.makedirs(ct)
    os.makedirs(lab)
    for cid in ids:
        nifti.save(rng.uniform(-300, 400, shape).astype(np.float32),
                   os.path.join(ct, f"PANCREAS_{cid}.nii.gz"))
        seg = np.zeros(shape, np.uint8)
        seg[3:7, 2:6, 2:5] = 1
        if cid != ids[-1]:                  # the last has no label file
            nifti.save(seg, os.path.join(lab, f"label{cid}.nii.gz"))
    return ct, lab


def test_pancreas_loader_matches_reference(tmp_path, rng):
    ct, lab = _write_pancreas(str(tmp_path), rng)
    for ids in (None, ["0002"]):
        assert loader.find_pancreas_cases(ct, lab, ids) == \
            jax_loader.find_pancreas_cases(ct, lab, ids)
    for _, ct_path, lab_path in loader.find_pancreas_cases(ct, lab):
        got = loader.load_pancreas_case(ct_path, lab_path)
        want = jax_loader.load_pancreas_case(ct_path, lab_path)
        for field in ("image", "weight", "label"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))


def test_sampler_matches_reference():
    """``patch_batches`` under the three policies drawing from one shared
    generator in turn (a generator a side, same seed), ``mixup_batches``,
    ``random_patch`` on a volume smaller than the patch and
    ``transpose_record``."""
    g = np.random.default_rng(11)
    shapes = [(20, 24, 18), (9, 30, 26), (14, 14, 40)]
    port_recs, ref_recs = [], []
    for i, shape in enumerate(shapes):
        img = g.standard_normal((2,) + shape).astype(np.float32)
        w = (g.uniform(size=shape) < 0.9).astype(np.float32)
        lab = np.zeros(shape, np.int32)
        if i != 1:                               # one record has no tumour
            lab[tuple(slice(s // 2 - 2, s // 2 + 2) for s in shape)] = 1
        port_recs.append(sampler.VolumeRecord(img, w, lab))
        ref_recs.append(jax_sampler.VolumeRecord(img, w, lab))
    r_port, r_ref = np.random.default_rng(5), np.random.default_rng(5)
    patch = (12, 16, 16)
    for policy in ("random", "one_positive", "all_positive"):
        got = sampler.patch_batches(port_recs, patch, 3, r_port, policy)
        want = jax_sampler.patch_batches(ref_recs, patch, 3, r_ref, policy)
        for _ in range(3):
            for a, b in zip(next(got), next(want)):
                assert a.dtype == b.dtype and a.shape == b.shape
                np.testing.assert_array_equal(a, b)
    got = sampler.mixup_batches(
        sampler.patch_batches(port_recs, patch, 2, r_port), 2, r_port)
    want = jax_sampler.mixup_batches(
        jax_sampler.patch_batches(ref_recs, patch, 2, r_ref), 2, r_ref)
    for _ in range(2):
        for a, b in zip(next(got), next(want)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(sampler.random_patch(port_recs[1], (16, 16, 16), r_port),
                    jax_sampler.random_patch(ref_recs[1], (16, 16, 16),
                                             r_ref)):
        np.testing.assert_array_equal(a, b)
    for direction in ("axial", "sagittal", "coronal"):
        got = sampler.transpose_record(port_recs[0], direction)
        want = jax_sampler.transpose_record(ref_recs[0], direction)
        for field in ("image", "weight", "label"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
    with pytest.raises(ValueError, match="no records"):
        next(sampler.patch_batches([], patch, 1, r_port))


# ------------------------------------------------------------------ #
# (c) UNet3D and the upsample


@pytest.mark.parametrize("deep_supervision", [True, False])
def test_unet3d_matches_reference(deep_supervision):
    jc = jax_cfg(base_filter=4, deep_supervision=deep_supervision)
    model, variables = jax_init(jax.random.PRNGKey(0), jc, attention=False)
    x = np.random.default_rng(3).standard_normal(
        (1, 16, 32, 32, 4)).astype(np.float32)
    want = np.asarray(jax.jit(
        lambda v: model.apply(variables, v, train=False))(jnp.asarray(x)))
    cfg = brats_saliency_config(base_filter=4,
                                deep_supervision=deep_supervision)
    port = saliency_unet.UNet3D(cfg)
    port.load_state_dict(
        convert_saliency(flat_variables(variables), cfg, attention=False))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    assert got.dtype == torch.float32 and got.shape == (1, 2, 16, 32, 32)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               atol=3e-4, rtol=1e-4)
    names = {k.rsplit("/", 1)[0] for k in flat_variables(variables)}
    assert any(n.endswith("Conv_2") for n in names) == deep_supervision


@pytest.mark.parametrize("scale", [2, 3])
def test_bilinear_upsample_matches_reference(rng, scale):
    x = rng.standard_normal((2, 3, 4, 5, 6)).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(np.moveaxis(x, 1, -1)), scale))
    got = bilinear_upsample_3d(torch.from_numpy(x), scale)
    assert got.shape == (2, 3, 4 * scale, 5 * scale, 6 * scale)
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               atol=1e-6, rtol=1e-6)


# ------------------------------------------------------------------ #
# (d) the learning-rate schedule


def test_lr_at_matches_optax_schedule():
    kw = dict(steps_per_epoch=7, lr_schedule=((2, 1e-3), (3, 4e-4),
                                              (5.5, 1e-4), (9, 2e-5)))
    ref = JaxTrainer(jax_cfg(**kw))
    port = SaliencyTrainer(brats_saliency_config(**kw), device="cpu")
    for b in (14, 21, 38, 63):
        for step in (0, b - 1, b, b + 1):
            assert port.lr_at(step) == float(ref._schedule(step)), step
    default = SaliencyTrainer(brats_saliency_config(), device="cpu")
    ref = JaxTrainer(jax_cfg())
    for epoch, _ in jax_cfg().lr_schedule:
        b = epoch * 250
        for step in (0, b - 1, b, b + 1):
            assert default.lr_at(step) == float(ref._schedule(step)), step


# ------------------------------------------------------------------ #
# (e) the optimizer (the train steps are in test_torch_saliency_step.py)


@pytest.mark.parametrize("attention,decay", [(True, 1e-5), (False, 1e-5),
                                             (True, 3e-4)])
def test_weight_decay_groups_match_kernel_mask(attention, decay):
    """The decayed group is exactly the reference's ``_kernel_mask``, for
    either net; the converted state's groups are the trainer's own, at
    the config's decay; it starts at the reference's step."""
    from pointunet_tpu.train.saliency import _kernel_mask

    state0 = JaxTrainer(jax_cfg(weight_decay=decay, **TINY),
                        attention=attention).init_state()
    mask = traverse_util.flatten_dict(_kernel_mask(state0.params), sep="/")
    cfg = brats_saliency_config(weight_decay=decay, **TINY)
    trainer, state = _port_state(_flat_state(state0), cfg, attention)
    decayed, rest = decay_split(state.model)
    def groups(opt):      # the rate is set at each update from lr_at
        return [{k: v for k, v in g.items() if k != "lr"}
                for g in opt.state_dict()["param_groups"]]

    assert groups(state.optimizer) == groups(trainer.init_state().optimizer)
    assert [g["weight_decay"] for g in state.optimizer.param_groups] == [
        decay, 0.0]
    got = named_to_flax_flat({n: p.detach() for n, p in
                              state.model.named_parameters() if n in decayed})
    assert set(got) == {f"params/{k}" for k, v in mask.items() if v}
    assert len(decayed) + len(rest) == len(mask) and state.step == 0


class _OneConv(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.Conv_0 = saliency_unet.Conv(2, 4, 3)


def test_sgd_matches_optax_chain(rng):
    """``torch.optim.SGD`` with the trainer's groups (``apply_update``)
    and the reference's optax chain (decay added before the momentum
    trace): three updates across a schedule boundary, the kernel decayed
    and the bias not."""
    cfg = dict(steps_per_epoch=1, lr_schedule=((2, 1e-3),))
    ref = JaxTrainer(jax_cfg(**cfg))
    port = SaliencyTrainer(brats_saliency_config(**cfg), device="cpu")
    flat = {"params/Conv_0/kernel":
            rng.standard_normal((3, 3, 3, 2, 4)).astype(np.float32),
            "params/Conv_0/bias": rng.standard_normal(4).astype(np.float32)}
    model = _OneConv()
    model.load_state_dict(convert_variables(flat, model))

    def tree(d):
        return traverse_util.unflatten_dict(
            {tuple(k.split("/")[1:]): jnp.asarray(v) for k, v in d.items()})

    params = tree(flat)
    tx = ref._make_tx(params)
    opt_state = tx.init(params)
    state = SaliencyTrainState(model, make_optimizer(model, 1e-5), 0)
    for _ in range(3):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in flat.items()}
        updates, opt_state = tx.update(tree(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        grads = convert_leaves(g, dict(model.named_parameters()))
        for name, p in model.named_parameters():
            p.grad = grads[name]
        port.apply_update(state, 1)
        want = flat_variables({"params": params})
        for key, arr in _params(state).items():
            np.testing.assert_allclose(arr, want[key], rtol=1e-6, atol=1e-7,
                                       err_msg=key)
    assert state.step == 3


# ------------------------------------------------------------------ #
# (f) remat


@pytest.mark.parametrize("attention", [True, False])
def test_remat_matches_no_remat(monkeypatch, attention):
    """22 blocks of either net run under ``checkpoint`` in training with
    remat, none without it or in inference; the gradients agree."""
    calls = []
    real = saliency_unet.checkpoint
    monkeypatch.setattr(saliency_unet, "checkpoint",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    img, w, lab = _batch(np.random.default_rng(4), b=1)
    grads = {}
    for remat in (True, False):
        trainer = SaliencyTrainer(brats_saliency_config(remat=remat, **TINY),
                                  device="cpu", attention=attention)
        state = trainer.init_state(seed=2)
        batch = trainer.prepare(img, w, lab)
        calls.clear()
        trainer.forward_loss(state, *batch).backward()
        assert len(calls) == (22 if remat else 0)
        grads[remat] = {n: p.grad for n, p in state.model.named_parameters()}
        calls.clear()
        assert trainer.predict_patch(state, batch[0]).shape == (1, 2, 16, 32, 32)
        assert not calls
    top = max(float(g.abs().max()) for g in grads[False].values())
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, rtol=0,
                                   atol=1e-6 * top, msg=name)


# ------------------------------------------------------------------ #
# (g) whole-volume prediction


def test_predictions_match_reference():
    """A (4, 24, 24, 24) volume (every view the same shape, so the
    reference compiles once) in three windows along D, the last padded."""
    kw = dict(TINY, xstep=6)
    ref = JaxTrainer(jax_cfg(**kw))
    cfg = brats_saliency_config(**kw)
    port = SaliencyTrainer(cfg, device="cpu")
    states = [ref.init_state(seed) for seed in range(3)]
    ports = [_port_state(_flat_state(s), cfg)[1] for s in states]
    vol = np.random.default_rng(6).standard_normal(
        (4, 24, 24, 24)).astype(np.float32)
    vol_ref = np.moveaxis(vol, 0, -1)

    def check(got, want):
        assert got.shape == (2, 24, 24, 24) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.moveaxis(np.asarray(want), -1, 0),
                                   rtol=0, atol=1e-4)
        np.testing.assert_allclose(got.sum(0), 1.0, rtol=0, atol=1e-5)

    check(port.predict_volume(ports[0], vol),
          ref.predict_volume(states[0], jnp.asarray(vol_ref)))
    check(port.predict_volume(ports[0], vol, dynamic_shape=True),
          ref.predict_volume(states[0], jnp.asarray(vol_ref),
                             dynamic_shape=True))
    check(port.predict_volume_tta(ports[1], vol, "sagittal", test_flip=True),
          ref.predict_volume_tta(states[1], vol_ref, "sagittal",
                                 test_flip=True))
    check(port.predict_volume_multiview(ports, vol),
          ref.predict_volume_multiview(states, vol_ref))


# ------------------------------------------------------------------ #
# (h) checkpoints


def test_checkpoint_resume_is_bit_equal(tmp_path):
    trainer = SaliencyTrainer(brats_saliency_config(**TINY), device="cpu")
    state = trainer.init_state(seed=1)
    b1 = _batch(np.random.default_rng(1), b=1)
    b2 = _batch(np.random.default_rng(2), b=1)
    parts = []
    trainer.train_step(state, *b1, mark=parts.append)
    assert parts == ["prepare", "forward_loss", "backward", "optimizer"]
    ck = BestMetricCheckpointer(str(tmp_path))
    ck.save(state, state.step, metric=0.25)
    _, m = trainer.train_step(state, *b2)
    fresh = trainer.init_state(seed=9)
    assert ck.restore_best(fresh) is fresh and fresh.step == 1
    _, again = trainer.train_step(fresh, *b2)
    assert again["loss"] == m["loss"] and fresh.step == state.step == 2
    for (name, p), q in zip(state.model.named_parameters(),
                            fresh.model.parameters()):
        assert torch.equal(p, q), name
        assert torch.equal(state.optimizer.state[p]["momentum_buffer"],
                           fresh.optimizer.state[q]["momentum_buffer"]), name


def test_restore_best_without_snapshots_returns_none(tmp_path):
    """A directory whose ``best.json`` names a step with no snapshot
    restores nothing (an orbax one of the JAX package, which also has
    step folders, exits naming the exporter:
    tests/test_torch_checkpoint_bridge.py)."""
    (tmp_path / "best.json").write_text('{"step": 7, "metric": 0.5}')
    state = SaliencyTrainer(brats_saliency_config(**TINY),
                            device="cpu").init_state()
    assert BestMetricCheckpointer(str(tmp_path)).restore_best(state) is None


def test_restore_best_with_its_snapshot_missing_raises(tmp_path):
    """A best step whose snapshot is gone, beside a later one, raises
    rather than loading another step."""
    trainer = SaliencyTrainer(brats_saliency_config(**TINY), device="cpu")
    state = trainer.init_state()
    ck = BestMetricCheckpointer(str(tmp_path))
    ck.save(state, 1, metric=0.5)
    ck.save(state, 2)
    os.remove(tmp_path / "best" / "1.pt")
    os.remove(tmp_path / "1.pt")
    assert ck.best_step() == 1 and ck.latest_step() == 2
    with pytest.raises(FileNotFoundError):
        ck.restore_best(trainer.init_state())


def test_convert_saliency_train_state_rejects_bad_states():
    flat = _flat_state(JaxTrainer(jax_cfg(**TINY)).init_state(seed=0))
    model = SaliencyTrainer(brats_saliency_config(**TINY),
                            device="cpu").init_state().model
    with pytest.raises(ValueError, match="differs from step"):
        convert_saliency_train_state(dict(flat, count=np.asarray(3)), model)
    with pytest.raises(KeyError, match="lacks"):
        convert_saliency_train_state(
            {k: v for k, v in flat.items() if k != "count"}, model)
    with pytest.raises(KeyError, match="unconvertible"):
        convert_saliency_train_state(dict(flat, **{"mu/x": 0}), model)
    key = next(k for k in flat if k.startswith("trace/"))
    with pytest.raises(ValueError, match="does not match"):
        convert_saliency_train_state(
            dict(flat, **{key: flat[key][..., :1]}), model)


# ------------------------------------------------------------------ #
# (i) the train_attention CLI


class _StubState:
    step = 0

    def state_dict(self):
        return {"step": self.step}

    def load_state_dict(self, d):
        self.step = d["step"]


class _StubTrainer:
    """Records the CLI's calls; returns fixed probabilities."""

    calls = []

    def __init__(self, cfg, tcfg=None, **kw):
        self.cfg = cfg
        type(self).calls.append(("init", kw.get("device"), cfg.direction))

    def init_state(self):
        return _StubState()

    def fit(self, state, batches, eval_records=None, checkpointer=None,
            log=print, max_steps=None, metrics=None):
        type(self).calls.append(("fit", len(eval_records)))
        metrics.log(1, loss=0.5)
        checkpointer.save(state, 1, 0.5)
        return state

    def evaluate(self, state, records, log=print):
        type(self).calls.append(
            ("evaluate", [r.image.shape[1:] for r in records]))
        return 0.5

    def predict_volume_tta(self, state, vol, direction="axial",
                           test_flip=False):
        type(self).calls.append(("predict", direction, vol.shape))
        return np.full((2,) + vol.shape[1:], 0.5, np.float32)


@pytest.mark.parametrize("dataset,direction", [("brats", None),
                                               ("pancreas", "coronal")])
def test_train_attention_wiring(tmp_path, rng, monkeypatch, dataset,
                                direction):
    _StubTrainer.calls = []
    monkeypatch.setattr(train_attention, "SaliencyTrainer", _StubTrainer)
    if dataset == "brats":
        basedir = tmp_path / "brats"
        make_brats_case(str(basedir), "case_001", rng=rng)
        make_brats_case(str(basedir), "case_002", rng=rng)
        extra, shape = [], (32, 32, 20)
    else:
        ct, lab = _write_pancreas(str(tmp_path), rng)
        basedir, extra, shape = ct, ["--label_dir", lab], (12, 10, 8)
    common = (["--dataset", dataset, "--basedir", str(basedir),
               "--logdir", str(tmp_path / "logs"), "--device", "cpu"]
              + extra + (["--direction", direction] if direction else []))
    train_attention.main(common + ["--max_epoch", "1"])
    view = direction or "axial"
    assert _StubTrainer.calls[:2] == [("init", "cpu", view), ("fit", 1)]
    with open(tmp_path / "logs" / "scalars.jsonl") as f:
        assert '"loss": 0.5' in f.read()

    train_attention.main(common + ["--evaluate"])
    zyx = shape[::-1]
    perm = {"axial": (0, 1, 2), "coronal": (1, 0, 2)}[view]
    evaluated = _StubTrainer.calls[-1]
    assert evaluated[0] == "evaluate"
    if dataset == "pancreas":                # uncropped: shapes are known
        assert evaluated[1] == [tuple(zyx[a] for a in perm)] * 2

    maps = tmp_path / "maps"
    train_attention.main(common + ["--predict", "--outPros_path", str(maps)])
    assert _StubTrainer.calls[-1][:2] == ("predict", view)
    for out in sorted(maps.iterdir()):
        arr = np.load(out)
        assert arr.shape == shape + (2,) and arr.dtype == np.float32


def _brats_case_with_margin(root, case_id, rng):
    """A (32, 32, 20) case whose brain box (x, y 8-24, z 6-14) leaves a
    border the crop removes; a tumour box inside it."""
    case_dir = os.path.join(root, case_id)
    os.makedirs(case_dir)
    shape = (32, 32, 20)
    seg = np.zeros(shape, np.uint8)
    seg[12:18, 13:19, 8:12] = 2
    for mod in loader.BRATS_MODALITIES:
        vol = np.zeros(shape, np.float32)
        vol[8:24, 8:24, 6:14] = rng.uniform(50, 100, (16, 16, 8))
        vol[seg > 0] += 100.0
        nifti.save(vol, os.path.join(case_dir, f"{case_id}_{mod}.nii.gz"))
    nifti.save(seg, os.path.join(case_dir, f"{case_id}_seg.nii.gz"))
    return case_dir


def test_train_attention_on_cpu(tmp_path, rng, monkeypatch):
    """Train (2 steps, an evaluation, a best checkpoint), ``--evaluate``
    and ``--predict`` for real at the small config: each map is the
    restored model's prediction placed at the case's crop box, zeros
    outside it."""
    cfg = brats_saliency_config(steps_per_epoch=2, max_epoch=1, eval_epoch=1,
                                **TINY)
    monkeypatch.setattr(train_attention, "brats_saliency_config",
                        lambda: cfg)
    basedir = tmp_path / "brats"
    cases = [_brats_case_with_margin(str(basedir), f"case_{i}", rng)
             for i in range(3)]
    logdir = tmp_path / "logs"
    common = ["--basedir", str(basedir), "--logdir", str(logdir),
              "--device", "cpu"]
    state = train_attention.main(common)
    assert state.step == 2
    assert (logdir / "snapshots" / "best.json").exists()
    assert "eval_dice" in (logdir / "scalars.jsonl").read_text()

    train_attention.main(common + ["--evaluate"])
    summary = (logdir / "train_summary.txt").read_text()
    assert summary.count("eval mean dice") == 2 and "over 3 volumes" in summary

    maps = tmp_path / "maps"
    state = train_attention.main(common + ["--predict", "--outPros_path",
                                           str(maps)])
    trainer = SaliencyTrainer(cfg, device="cpu")
    for case_dir in cases:
        rec, meta = loader.load_brats_case(case_dir, with_label=False)
        arr = np.load(maps / f"{meta['case_id']}.npy")
        assert arr.shape == (32, 32, 20, 2) and arr.dtype == np.float32
        (zlo, zhi), (ylo, yhi), (xlo, xhi) = meta["bbox"]
        inside = np.zeros(arr.shape[:3], bool)
        inside[xlo:xhi, ylo:yhi, zlo:zhi] = True
        assert 0 < inside.sum() < inside.size
        np.testing.assert_array_equal(
            arr[xlo:xhi, ylo:yhi, zlo:zhi],
            trainer.predict_volume(state, rec.image).transpose(3, 2, 1, 0))
        assert not arr[~inside].any()
        np.testing.assert_allclose(arr[inside].sum(-1), 1.0, atol=1e-5)


# ------------------------------------------------------------------ #
# (j) kernel 3's guard


def test_conv_guard_refuses_a_needed_gradient():
    x = torch.zeros(1, 2, 3, 4, 5)
    w = torch.zeros(3, 2, 3, 3, 3, requires_grad=True)
    with pytest.raises(RuntimeError,
                       match="no backward.*POINTUNET_FASTCONV unset"):
        conv_cuda.refuse_autograd(x, w, None)
    with pytest.raises(RuntimeError, match="no backward"):
        conv_cuda.refuse_autograd(x.requires_grad_(True), w.detach(), None)
    conv_cuda.refuse_autograd(x.detach(), w.detach(), None)
    with torch.no_grad():
        conv_cuda.refuse_autograd(x, w, None)
    with torch.inference_mode():
        conv_cuda.refuse_autograd(x, w, None)
    # the CPU route stays the plain, differentiable version
    g = torch.Generator().manual_seed(0)
    xs = [torch.randn(s, generator=g, requires_grad=True)
          for s in ((1, 2, 3, 4, 5), (3, 2, 3, 3, 3), (3,))]
    conv_cuda.conv3d_3x3(*xs).square().sum().backward()
    got = [t.grad for t in xs]
    ys = [t.detach().clone().requires_grad_(True) for t in xs]
    torch.nn.functional.conv3d(*ys, padding=1).square().sum().backward()
    for a, b in zip(got, ys):
        torch.testing.assert_close(a, b.grad, rtol=1e-5, atol=1e-5)
