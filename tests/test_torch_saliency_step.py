"""One saliency train step of the port (pointunet_tpu_torch/train/saliency.py)
against the reference's, then a second from the reference's own state
after step 1, on the CPU: ``SaliencyUNet`` at (16, 32, 32) with
``base_filter`` 4, batch 2. The gradients are held in f64 on both sides,
the loss and the updated parameters in f32. The tolerances and why they
are what they are: tests/test_torch_saliency_train.py's docstring. This file holds the
suite's most expensive fixture (the reference's f64 gradients), apart
from the other saliency tests so that the two run on separate workers.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from flax import traverse_util

from pointunet_tpu.core.config import brats_saliency_config as jax_cfg
from pointunet_tpu.models import losses as jax_losses
from pointunet_tpu.train.saliency import SaliencyTrainer as JaxTrainer
from pointunet_tpu_torch.core.config import brats_saliency_config
from pointunet_tpu_torch.train.saliency import (
    MOMENTUM,
    SaliencyTrainState,
    decay_split,
)
from test_torch_saliency_train import (
    BIAS_BEFORE_NORM,
    GRAD64_BAR,
    GRAD_BAR,
    TINY,
    ZERO_GRAD_BAR,
    _batch,
    _flat_state,
    _params,
    _port_state,
)
from torch_parity import named_to_flax_flat


@pytest.fixture(scope="module")
def step_reference():
    """The reference trainer's states 0, 1 and 2 on one batch, with the
    losses of steps 1 and 2, and the loss and gradients of step 1 run in
    f64 from the same f32 weights and inputs.

    Each f32 step is the reference's ``train_step`` as it composes it:
    its micro-batch ``value_and_grad`` of ``saliency_dice_loss`` over the
    model's training forward, the per-sample gradients and losses summed
    and divided by B, its optax chain (``_make_tx``) and ``step + 1``;
    the micro-batch loop runs in Python instead of ``lax.scan``, which
    takes ~60 s a step on the CPU (its jitted ``train_step``; measured)."""
    cfg = jax_cfg(remat=False, **TINY)
    trainer = JaxTrainer(cfg)
    state0 = trainer.init_state(seed=0)
    img, w, lab = _batch(np.random.default_rng(7))
    b = img.shape[0]

    def micro(params, im, ww, ll):
        logits = trainer.model.apply({"params": params}, im, train=True)
        return jax_losses.saliency_dice_loss(logits, ww, ll)

    grad_fn = jax.jit(jax.value_and_grad(micro))

    def loss_and_grads(params, dtype):
        cast = lambda a: jnp.asarray(np.asarray(a), dtype)  # noqa: E731
        params = jax.tree_util.tree_map(cast, params)
        total, grads = 0.0, None
        for i in range(b):
            l_i, g_i = grad_fn(params, cast(img[i:i + 1]), cast(w[i:i + 1]),
                               jnp.asarray(lab[i:i + 1]))
            total = total + l_i
            grads = g_i if grads is None else jax.tree_util.tree_map(
                jnp.add, grads, g_i)
        return total / b, jax.tree_util.tree_map(lambda g: g / b, grads)

    def step(state):
        loss, grads = loss_and_grads(state.params, jnp.float32)
        updates, opt_state = trainer.tx.update(grads, state.opt_state,
                                               state.params)
        return state._replace(
            params=optax.apply_updates(state.params, updates),
            opt_state=opt_state, step=state.step + 1,
        ), float(loss)

    with jax.enable_x64(True):
        loss64, grads64 = loss_and_grads(state0.params, jnp.float64)
        grads64 = {f"params/{k}": np.asarray(v) for k, v in
                   traverse_util.flatten_dict(grads64, sep="/").items()}
    state1, loss1 = step(state0)
    state2, loss2 = step(state1)
    return {
        "flat0": _flat_state(state0), "flat1": _flat_state(state1),
        "flat2": _flat_state(state2), "loss1": loss1, "loss2": loss2,
        "loss64": float(loss64), "grads64": grads64, "batch": (img, w, lab),
        "lr": [float(trainer._schedule(s)) for s in (0, 1)],
    }


def _step_bar(ref) -> float:
    return max(float(np.abs(g).max()) for g in ref["grads64"].values())


def _assert_params_close(got, want_flat, lr, top):
    atol = lr * GRAD_BAR * top + 1e-7
    for key, want in want_flat.items():
        if key.startswith("params/"):
            np.testing.assert_allclose(got[key], want, rtol=0, atol=atol,
                                       err_msg=key)


def _port_grads64(trainer, state, batch) -> dict:
    """The port's step gradients in f64 from the same f32 weights and
    inputs: a copy of the model in f64, the micro-batches' ``forward_loss``
    gradients summed and divided by B, as ``train_step`` takes them."""
    model = copy.deepcopy(state.model).double()
    state64 = SaliencyTrainState(model, None, state.step)
    images, weights, labels = trainer.prepare(*batch)
    images, weights = images.double(), weights.double()
    b = images.shape[0]
    for i in range(b):
        trainer.forward_loss(state64, images[i:i + 1], weights[i:i + 1],
                             labels[i:i + 1]).backward()
    return named_to_flax_flat(
        {n: p.grad / b for n, p in model.named_parameters()})


def test_train_step_matches_reference(step_reference):
    ref = step_reference
    trainer, state = _port_state(ref["flat0"], brats_saliency_config(**TINY))
    assert trainer.cfg.remat and state.step == 0
    # the gradients, both sides in f64, leaf by leaf
    grads = _port_grads64(trainer, state, ref["batch"])
    assert set(grads) == set(ref["grads64"])
    top = _step_bar(ref)
    for key, want in ref["grads64"].items():
        got = np.asarray(grads[key])
        assert got.dtype == np.float64, key
        if BIAS_BEFORE_NORM.search(key):
            assert float(np.abs(want).max()) < ZERO_GRAD_BAR * top, key
            assert float(np.abs(got).max()) < ZERO_GRAD_BAR * top, key
            continue
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=GRAD64_BAR * np.abs(want).max(),
                                   err_msg=key)
    # the f32 step itself: its loss and the parameters it leaves
    state, m = trainer.train_step(state, *ref["batch"])
    assert state.step == 1
    np.testing.assert_allclose(m["loss"], ref["loss64"], rtol=1e-5)
    np.testing.assert_allclose(m["loss"], ref["loss1"], rtol=1e-5)
    _assert_params_close(_params(state), ref["flat1"], ref["lr"][0], top)


def test_second_step_carries_the_momentum(step_reference):
    ref = step_reference
    trainer, state = _port_state(ref["flat1"], brats_saliency_config(**TINY))
    assert state.step == 1
    # the trace arrives as SGD's momentum buffers, group by group
    opt = state.optimizer
    names = [n for group in decay_split(state.model) for n in group]
    buffers = named_to_flax_flat(
        {n: opt.state[p]["momentum_buffer"] for n, p in zip(
            names, (p for g in opt.param_groups for p in g["params"]))})
    for key, arr in buffers.items():
        np.testing.assert_array_equal(arr, ref["flat1"]["trace/" + key[7:]])
    state, m = trainer.train_step(state, *ref["batch"])
    np.testing.assert_allclose(m["loss"], ref["loss2"], rtol=1e-5)
    top = _step_bar(ref)
    _assert_params_close(_params(state), ref["flat2"], ref["lr"][1], top)
    # the momentum term moves weights by far more than the bar
    momentum = max(MOMENTUM * ref["lr"][1] * float(np.abs(v).max())
                   for k, v in ref["flat1"].items() if k.startswith("trace/"))
    assert momentum > 10 * (ref["lr"][1] * GRAD_BAR * top + 1e-7)
