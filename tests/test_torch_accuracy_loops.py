"""The loops of the port's accuracy path (pointunet_tpu_torch/cli/
accuracy.py: ``train_saliency``, ``train_pointseg``) against the
reference's (bench.py:851-877 and :887-910), on the CPU at small sizes.

From the reference's initial weights (``convert.py``), on the same
``patch_batches`` batches and the reference's own clouds, 3 saliency and
3 point steps of the port's loop give the reference loop's losses within
rtol 1e-4, f32 on both sides, dropout off on both (the two draw their
masks from other generators).

* The reference's saliency step is composed from its parts, as
  tests/test_torch_saliency_step.py composes it: its jitted
  ``train_step`` takes ~20 s a step on the CPU (measured).
* The saliency loop runs at base_lr 1e-3, not the accuracy path's 0.01.
  At 0.01 and this (16, 32, 32) patch, the reference's own f32 loop
  leaves its f64 loop by 6.9e-5 and 3.2e-3 relative at steps 2 and 3
  (measured): the f32 gradient's ill-conditioning that
  tests/test_torch_saliency_train.py describes, compounded by SGD. No f32
  loop can be held to 1e-4 there. At 1e-3 the reference's f32 loop stays
  within 8.5e-6 of its f64 loop over 3 steps, and the port within 1.4e-6
  of the reference.
* The point loop's steps take the reference's pyramid of each cloud: its
  neighbour lists break distance ties otherwise than the port's, which
  moves the first loss by 1.9e-3 relative here (the pyramids are held by
  tie-aware recall in tests/test_torch_pyramid.py).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict as flax_flatten

import bench
from pointunet_tpu.core.config import TrainConfig as JaxTrainConfig
from pointunet_tpu.core.config import brats_pointseg_config as jax_pcfg
from pointunet_tpu.core.config import brats_saliency_config as jax_scfg
from pointunet_tpu.data.sampler import VolumeRecord as JaxRecord
from pointunet_tpu.data.sampler import patch_batches as jax_patch_batches
from pointunet_tpu.models import losses as jax_losses
from pointunet_tpu.ops.sampling import sample_cloud_device as jax_sample
from pointunet_tpu.train.pointseg import PointSegTrainer as JaxPointTrainer
from pointunet_tpu.train.saliency import SaliencyTrainer as JaxSalTrainer
from pointunet_tpu_torch.cli import accuracy
from pointunet_tpu_torch.convert import (
    convert_saliency_train_state,
    convert_train_state,
)
from pointunet_tpu_torch.core.config import (
    brats_pointseg_config,
    brats_saliency_config,
)
from pointunet_tpu_torch.ops.pyramid import Pyramid
from pointunet_tpu_torch.ops.sampling import DeviceCloud
from pointunet_tpu_torch.train.pointseg import PointSegTrainer
from pointunet_tpu_torch.train.saliency import SaliencyTrainer
from test_torch_saliency_train import (
    BIAS_BEFORE_NORM,
    TINY,
    _batch,
    _flat_state,
    _port_state,
)
from test_torch_train import _flat_train_state
from torch_parity import named_to_flax_flat, to_torch

torch.set_num_threads(2)

GLUE_SHAPE = (40, 36, 20)          # (X, Y, Z): (16, 32, 32) patches crop
GLUE_POINTS = 8192
GLUE_STEPS = 3


@pytest.fixture(scope="module")
def glue_volumes():
    return [bench._synth_brats_volume(np.random.default_rng(s), GLUE_SHAPE)
            for s in range(4)]


def test_saliency_loop_matches_reference(glue_volumes):
    """3 steps of ``train_saliency`` from the reference's initial weights
    against the reference loop (bench.py:851-877) on the same batches."""
    vols = glue_volumes
    kw = dict(base_filter=4, patch_size=(16, 32, 32), batch_size=1,
              base_lr=1e-3)
    trainer = JaxSalTrainer(jax_scfg(remat=False, **kw),
                            JaxTrainConfig(donate_state=False))
    state = trainer.init_state(seed=0)
    flat = _flat_state(state)

    def micro(params, im, w, lab):
        logits = trainer.model.apply({"params": params}, im, train=True)
        return jax_losses.saliency_dice_loss(logits, w, lab)

    grad_fn = jax.jit(jax.value_and_grad(micro))
    records = []
    for mods, seg in vols:
        vol = np.transpose(mods, (0, 3, 2, 1))
        lab = (np.transpose(seg, (2, 1, 0)) > 0).astype(np.int32)
        records.append(JaxRecord(vol, np.ones_like(lab, np.float32), lab))
    batches = jax_patch_batches(records, trainer.cfg.patch_size, 1,
                                np.random.default_rng(1), "one_positive")
    want = []
    for _, (im, w, lab) in zip(range(GLUE_STEPS), batches):
        # the reference's train_step at batch 1: one micro-batch
        loss, grads = grad_fn(state.params, jnp.asarray(im), jnp.asarray(w),
                              jnp.asarray(lab))
        updates, opt_state = trainer.tx.update(grads, state.opt_state,
                                               state.params)
        state = state._replace(params=optax.apply_updates(state.params,
                                                          updates),
                               opt_state=opt_state, step=state.step + 1)
        want.append(float(loss))

    port = SaliencyTrainer(brats_saliency_config(**kw), device="cpu")
    pstate = port.init_state()
    pstate.load_state_dict(convert_saliency_train_state(flat, pstate.model))
    pstate, got = accuracy.train_saliency(
        port, pstate, accuracy.saliency_records(vols, "brats"), GLUE_STEPS,
        log=lambda *_: None)
    assert pstate.step == GLUE_STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


def test_pointseg_loop_matches_reference(glue_volumes):
    """3 steps of ``train_pointseg`` from the reference's initial weights
    on the reference's clouds (its ``sample_cloud_device`` with
    ``PRNGKey(i)``, injected as numpy) against the reference loop
    (bench.py:887-910)."""
    vols = glue_volumes
    kw = dict(num_points=GLUE_POINTS, d_out=(16, 32, 32, 32, 32),
              learning_rate=1e-3, dropout_rate=0.0, use_bfloat16=False)
    trainer = JaxPointTrainer(jax_pcfg(**kw),
                              JaxTrainConfig(donate_state=False),
                              num_points=GLUE_POINTS)
    state = trainer.init_state()
    flat = _flat_train_state(state)
    clouds = [
        jax_sample(jnp.asarray(mods), jnp.asarray((seg > 0).astype(np.uint8)),
                   jax.random.PRNGKey(i), GLUE_POINTS,
                   labels=jnp.asarray(seg))
        for i, (mods, seg) in enumerate(vols)]
    want = []
    for k in range(GLUE_STEPS):
        c = clouds[k % len(clouds)]
        feats = jnp.concatenate([c.xyz, c.features], -1)[None]
        state, m = trainer.train_step(state, c.xyz[None], feats,
                                      c.labels[None])
        want.append(float(m["loss"]))

    port = PointSegTrainer(brats_pointseg_config(**kw), device="cpu")
    pstate = port.init_state()
    pstate.load_state_dict(convert_train_state(flat, pstate.model))
    port_clouds = [DeviceCloud(*(torch.from_numpy(np.array(a)) for a in c))
                   for c in clouds]
    # each step's pyramid: the reference's of that cloud
    pyramids = {
        np.asarray(c.xyz).tobytes(): Pyramid(*to_torch(
            trainer.pyramid_fn(c.xyz[None])))
        for c in clouds}
    port.pyramid_fn = lambda xyz: pyramids[xyz[0].numpy().tobytes()]
    pstate, got = accuracy.train_pointseg(port, pstate, port_clouds,
                                          GLUE_STEPS, log=lambda *_: None)
    assert pstate.step == GLUE_STEPS
    np.testing.assert_allclose(got, want, rtol=1e-4)


# ------------------------------------------------------------------ #
# the initial draws


@pytest.mark.parametrize("net", ["pointseg", "saliency"])
def test_initial_weights_follow_the_reference_distribution(net):
    """The accuracy path's Dice at the contract depends on the nets'
    initial draws (probe_accuracy.py, ROADMAP queue 3). The port's
    initialisation is the reference's distribution, not its draw: every
    parameter of the full-width net has the reference's shape, the
    zero/one-initialised ones its values, and each weight leaf of 256 or
    more entries its std within 15 % (the sampling error of a std over
    n >= 256 draws is ~4.4 %, so 15 % is over 3 of it)."""
    from pointunet_tpu.models.randlanet import init_randlanet as jax_rla
    from pointunet_tpu.models.saliency_unet import init_saliency_unet as jax_sal
    from pointunet_tpu_torch.models.randlanet import init_randlanet
    from pointunet_tpu_torch.models.saliency_unet import init_saliency_unet
    from torch_parity import flat_variables

    if net == "pointseg":
        _, variables = jax_rla(jax.random.PRNGKey(0), jax_pcfg(),
                               num_points=8192)
        model = init_randlanet(brats_pointseg_config(),
                               torch.Generator().manual_seed(0))
    else:
        _, variables = jax_sal(jax.random.PRNGKey(0), jax_scfg())
        model = init_saliency_unet(brats_saliency_config(),
                                   torch.Generator().manual_seed(0))
    want = flat_variables(variables)
    got = named_to_flax_flat(model.state_dict())
    assert set(got) == set(want)
    drawn = 0
    for key, w in want.items():
        g = got[key]
        assert g.shape == w.shape, key
        if np.all(w == w.flat[0]):             # zeros and ones
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif w.size >= 256:
            drawn += 1
            ratio = float(np.std(g) / np.std(w))
            assert abs(ratio - 1.0) < 0.15, (key, ratio)
            assert not np.array_equal(g, w), key
    assert drawn >= 20


# ------------------------------------------------------------------ #
# the saliency net in bf16


def _saliency_gradients(use_bfloat16: bool, batch) -> tuple:
    """The loss and gradients (flat, f64, the biases that feed an
    instance norm left out: zero analytically) of one training forward of
    the reference's saliency net at init and of the port's from the same
    weights, on ``batch``."""
    img, w, lab = batch
    trainer = JaxSalTrainer(jax_scfg(remat=False, use_bfloat16=use_bfloat16,
                                     **TINY))
    state = trainer.init_state(seed=0)

    def loss_fn(params):
        logits = trainer.model.apply({"params": params}, jnp.asarray(img),
                                     train=True)
        return jax_losses.saliency_dice_loss(logits, jnp.asarray(w),
                                             jnp.asarray(lab))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(state.params)
    ref = {f"params/{k}": np.asarray(v, np.float64) for k, v in
           flax_flatten(grads, sep="/").items()}
    port, pstate = _port_state(_flat_state(state), brats_saliency_config(
        remat=False, use_bfloat16=use_bfloat16, **TINY))
    port.forward_loss(pstate, *port.prepare(img, w, lab)).backward()
    got = {k: np.asarray(v, np.float64) for k, v in named_to_flax_flat(
        {n: p.grad for n, p in pstate.model.named_parameters()}).items()}
    keep = [k for k in ref if not BIAS_BEFORE_NORM.search(k)]
    return ({k: ref[k] for k in keep}, {k: got[k] for k in keep})


def _rel_l2(a: dict, b: dict) -> float:
    """|a - b| / |b| over all leaves."""
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in b)
    return float(np.sqrt(num / sum(float((b[k] ** 2).sum()) for k in b)))


def test_bf16_saliency_gradient_is_rounding_bound():
    """With ``--saliency_bf16`` the accuracy path trains the saliency net
    in bf16 on the card, as the reference trains it on its TPU (f32 is the
    default). At init, one bf16 step's gradient is far from the f32 one on
    both sides, so 400 bf16 steps follow the rounding, not the f32
    gradient; in f32 the port's gradient is the reference's (4.0e-5
    here). The weights are the reference's threefry draw (JAX's default,
    ``probe_bf16_gap.py``'s; the suite draws with rbg), where the
    reference's own bf16 gradient lies nearest its f32 one. Measured at
    base_filter 4 under the suite's XLA flags, |g_bf16 - g_f32| /
    |g_f32| of the reference / of the port / the bf16 gradients' distance
    |g_port - g_ref| / |g_ref|: 0.5356 / 0.5776 / 0.3710; the port
    before its norms rounded where flax's do (commit 2d792ac,
    tests/test_torch_bf16_rounding.py): 0.6781 / 0.3978. Held: the
    port's gap within 1.15x the reference's (measured 1.078x, the
    parent's 1.266x), the bf16 gradients within 0.39 of each other (the
    parent's 0.3978)."""
    prng = jax.config.jax_default_prng_impl
    jax.config.update("jax_default_prng_impl", "threefry2x32")
    try:
        batch = _batch(np.random.default_rng(7), b=1)
        ref32, port32 = _saliency_gradients(False, batch)
        ref16, port16 = _saliency_gradients(True, batch)
    finally:
        jax.config.update("jax_default_prng_impl", prng)
    assert _rel_l2(port32, ref32) < 2e-3
    ref_gap, port_gap = _rel_l2(ref16, ref32), _rel_l2(port16, port32)
    assert ref_gap > 0.3 and port_gap > 0.3, (ref_gap, port_gap)
    assert port_gap < 1.15 * ref_gap, (ref_gap, port_gap)
    assert _rel_l2(port16, ref16) < 0.39
