"""The reference's saliency step as ``probe_saliency_trajectory.py``
composes it (``reference_step``: the trainer's ``model.apply`` and
``saliency_dice_loss`` under ``jax.value_and_grad``, its ``tx.update`` and
``optax.apply_updates`` in one ``jax.jit``) against the trainer's own
``train_step`` (its gradient inside a ``lax.scan`` over micro-batches),
on the CPU: batch 1, the tests' tiny config (base_filter 4, patch (16,
32, 32)), 2 steps from one draw on two seeded batches.

At batch 1 the scan sums one gradient onto zeros and divides it by 1, so
the arithmetic is the same; XLA fuses the two programs otherwise and
their f32 sums may round apart, and the second step's gradient, from
weights a few ulps apart, is ill-conditioned (tests/test_torch_saliency_
train.py). Measured on this CPU: the first losses equal, the second 2.6e-7
apart relative, the parameters within 8.8e-7 absolute after 2 steps (7
f32 ulps at the largest |param|, 1.0). Bars: losses within rtol 2e-6,
parameters within 4e-6 absolute. ~60 s on an 8-core CPU, most of it
the two programs' compiles.
"""
import jax
import jax.numpy as jnp
import numpy as np
from flax import traverse_util

from pointunet_tpu.core.config import TrainConfig
from pointunet_tpu.core.config import brats_saliency_config as jax_cfg
from pointunet_tpu.train.saliency import SaliencyTrainer
from probe_saliency_trajectory import reference_step
from test_torch_saliency_train import TINY, _batch


def _flat(params) -> dict:
    return {k: np.asarray(v)
            for k, v in traverse_util.flatten_dict(params, sep="/").items()}


def test_composed_step_is_train_step():
    trainer = SaliencyTrainer(
        jax_cfg(batch_size=1, base_lr=0.01, **TINY),
        TrainConfig(donate_state=False))
    state0 = trainer.init_state(seed=0)
    batches = [_batch(np.random.default_rng(s), b=1) for s in (7, 8)]
    step = reference_step(trainer)
    params, opt_state = state0.params, state0.opt_state
    composed = []
    for im, w, lab in batches:
        params, opt_state, loss, _ = step(params, opt_state, jnp.asarray(im),
                                          jnp.asarray(w), jnp.asarray(lab))
        composed.append(float(loss))
    state = trainer.init_state(seed=0)
    scanned = []
    for im, w, lab in batches:
        state, m = trainer.train_step(state, jnp.asarray(im), jnp.asarray(w),
                                      jnp.asarray(lab))
        scanned.append(float(m["loss"]))
    np.testing.assert_allclose(composed, scanned, rtol=2e-6)
    got, want = _flat(params), _flat(state.params)
    assert set(got) == set(want)
    moved = max(float(np.abs(want[k] - v).max())
                for k, v in _flat(state0.params).items())
    assert moved > 1e-4                      # the steps moved the weights
    for key, v in want.items():
        np.testing.assert_allclose(got[key], v, rtol=0, atol=4e-6,
                                   err_msg=key)
