"""The port's saliency net (pointunet_tpu_torch/models/saliency_unet.py,
train/saliency.py) against the reference's where the CFE3D blocks'
dilated convs read real voxels: patch (32, 32, 32), whose 1/4 level is
(8, 8, 8), so every rate (3, 5, 7) of the c3 block reaches voxels of the
input in every axis. The other parity tests run at (16, 32, 32), where
the 1/4 level's depth is 4 and rates 5 and 7 read only padding in z.

* the full-width net's eval forward (base_filter 16, gate stride 1 and
  2), f32: logits within atol 3e-4, rtol 1e-4
  (tests/test_torch_saliency.py's bar and its reasons);
* one training step's gradient at base_filter 4, batch 1, in f64 on both
  sides from the same f32 weights and inputs: every leaf within
  ``GRAD64_BAR`` x its own largest gradient, the conv biases that feed an
  instance norm below ``ZERO_GRAD_BAR`` x the model's largest
  (tests/test_torch_saliency_train.py's bars and their reasons).

Measured on an 8-core CPU: ~80 s in all, 65 s of it the step test
(the reference's jitted f64 gradient, compiled and run, and the port's
in f64), 7 and 5 s the forwards.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from pointunet_tpu.core.config import brats_saliency_config as jax_cfg
from pointunet_tpu.models import losses as jax_losses
from pointunet_tpu.models.saliency_unet import init_saliency_unet as jax_init
from pointunet_tpu.train.saliency import SaliencyTrainer as JaxTrainer
from pointunet_tpu_torch.convert import convert_saliency
from pointunet_tpu_torch.core.config import brats_saliency_config
from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet
from pointunet_tpu_torch.train.saliency import SaliencyTrainState
from test_torch_saliency_train import (
    BIAS_BEFORE_NORM,
    GRAD64_BAR,
    ZERO_GRAD_BAR,
    _batch,
    _flat_state,
    _port_state,
)
from torch_parity import flat_variables, named_to_flax_flat

torch.set_num_threads(2)

PATCH = (32, 32, 32)


@pytest.mark.parametrize("stride", [1, 2])
def test_full_width_forward_where_dilations_read_voxels(stride):
    cfg = dict(sa_gate_stride=stride, patch_size=PATCH,
               inference_patch_size=PATCH)
    model, variables = jax_init(jax.random.PRNGKey(0), jax_cfg(**cfg))
    x = np.random.default_rng(stride).standard_normal(
        (1,) + PATCH + (4,)).astype(np.float32)
    want = np.asarray(jax.jit(lambda v, xx: model.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))
    port = SaliencyUNet(brats_saliency_config(**cfg))
    port.load_state_dict(convert_saliency(flat_variables(variables),
                                          port.config))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).numpy(), want,
                               atol=3e-4, rtol=1e-4)


def test_step_gradient_where_dilations_read_voxels():
    tiny = dict(base_filter=4, patch_size=PATCH, inference_patch_size=PATCH)
    trainer = JaxTrainer(jax_cfg(remat=False, **tiny))
    state = trainer.init_state(seed=0)
    img, w, lab = _batch(np.random.default_rng(7), b=1, patch=PATCH)

    def loss_fn(params, im, ww, ll):
        logits = trainer.model.apply({"params": params}, im, train=True)
        return jax_losses.saliency_dice_loss(logits, ww, ll)

    with jax.enable_x64(True):
        cast = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
        _, grads = jax.jit(jax.value_and_grad(loss_fn))(
            jax.tree_util.tree_map(cast, state.params), cast(img), cast(w),
            jnp.asarray(lab))
        want = {f"params/{k}": np.asarray(v) for k, v in
                traverse_util.flatten_dict(grads, sep="/").items()}

    port, pstate = _port_state(_flat_state(state),
                               brats_saliency_config(**tiny))
    model = copy.deepcopy(pstate.model).double()
    images, weights, labels = port.prepare(img, w, lab)
    port.forward_loss(SaliencyTrainState(model, None, 0), images.double(),
                      weights.double(), labels).backward()
    got = named_to_flax_flat({n: p.grad for n, p in model.named_parameters()})
    assert set(got) == set(want)
    top = max(float(np.abs(g).max()) for g in want.values())
    for key, g in want.items():
        if BIAS_BEFORE_NORM.search(key):
            assert float(np.abs(g).max()) < ZERO_GRAD_BAR * top, key
            assert float(np.abs(got[key]).max()) < ZERO_GRAD_BAR * top, key
            continue
        np.testing.assert_allclose(np.asarray(got[key]), g, rtol=0,
                                   atol=GRAD64_BAR * np.abs(g).max(),
                                   err_msg=key)
