"""The batch-norm flavour of the port's ``NormRelu``
(pointunet_tpu_torch/models/norms.py) against the reference's
(pointunet_tpu/models/norms.py: flax ``BatchNorm`` over the channels,
momentum 0.9, eps 1e-5), on the CPU with inputs made by numpy from a
seed; and what the saliency trainer does with it.

Bars (f32): outputs within 1e-5 and running statistics within 1e-6 (the
same formula, reductions in another order). Remat on and off in the
port: running statistics and gradients bit-equal after one train step
(the recomputation in the backward leaves the statistics alone, as
flax's remat, a pure function, does).
"""
import jax.numpy as jnp
import numpy as np
import torch

from pointunet_tpu.models.norms import NormRelu as RefNormRelu
from pointunet_tpu_torch.core.config import brats_saliency_config
from pointunet_tpu_torch.models.norms import BatchNorm, NormRelu
from pointunet_tpu_torch.train.saliency import SaliencyTrainer, decay_split

torch.set_num_threads(1)

C = 6


def _variables(rng):
    return {
        "params": {"BatchNorm_0": {
            "scale": rng.uniform(0.5, 1.5, C).astype(np.float32),
            "bias": rng.standard_normal(C).astype(np.float32)}},
        "batch_stats": {"BatchNorm_0": {
            "mean": rng.standard_normal(C).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}},
    }


def _port(variables) -> NormRelu:
    m = NormRelu(C, instance_norm=False)
    bn = m.norm
    assert isinstance(bn, BatchNorm) and "BatchNorm_0.weight" in dict(
        m.named_parameters())
    p, s = variables["params"]["BatchNorm_0"], variables["batch_stats"][
        "BatchNorm_0"]
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(p["scale"]))
        bn.bias.copy_(torch.from_numpy(p["bias"]))
        bn.running_mean.copy_(torch.from_numpy(s["mean"]))
        bn.running_var.copy_(torch.from_numpy(s["var"]))
    return m


def _x(rng, shape=(2, 5, 6, 7, C)):
    return (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)


def _to_port(x):                      # (B, D, H, W, C) -> (B, C, D, H, W)
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 4, 1, 2, 3)))


def _to_ref(t):
    return t.detach().numpy().transpose(0, 2, 3, 4, 1)


def test_batch_norm_relu_eval_matches_flax(rng):
    variables, x = _variables(rng), _x(rng)
    want = RefNormRelu(instance_norm=False).apply(
        variables, jnp.asarray(x), train=False)
    got = _port(variables).eval()(_to_port(x))
    np.testing.assert_allclose(_to_ref(got), np.asarray(want),
                               atol=1e-5, rtol=1e-5)


def test_batch_norm_relu_train_matches_flax(rng):
    """Two train-mode calls: each output from the batch's statistics, the
    running ones updated after each as flax does."""
    variables = _variables(rng)
    port = _port(variables).train()
    ref = RefNormRelu(instance_norm=False)
    for _ in range(2):
        x = _x(rng)
        want, mutated = ref.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
        variables = {"params": variables["params"], **mutated}
        got = port(_to_port(x))
        np.testing.assert_allclose(_to_ref(got), np.asarray(want),
                                   atol=1e-5, rtol=1e-5)
        stats = variables["batch_stats"]["BatchNorm_0"]
        np.testing.assert_allclose(port.norm.running_mean.numpy(),
                                   np.asarray(stats["mean"]), atol=1e-6)
        np.testing.assert_allclose(port.norm.running_var.numpy(),
                                   np.asarray(stats["var"]), atol=1e-6)


def _step(remat: bool):
    cfg = brats_saliency_config(
        base_filter=4, patch_size=(16, 32, 32), instance_norm=False,
        remat=remat)
    trainer = SaliencyTrainer(cfg, device="cpu")
    state = trainer.init_state(seed=1)
    rng = np.random.default_rng(0)
    img = rng.standard_normal((1, 16, 32, 32, 4)).astype(np.float32)
    lab = (img[..., 0] > 1).astype(np.int32)
    trainer.train_step(state, img, np.ones(lab.shape, np.float32), lab)
    return state


def test_saliency_step_updates_batch_norm_stats_once_under_remat():
    """A train step in the batch-norm flavour moves every running
    statistic once: with remat on (the blocks recomputed in the
    backward) the statistics, weights and momentum equal remat off's."""
    on, off = _step(True), _step(False)
    sd_on, sd_off = on.model.state_dict(), off.model.state_dict()
    stats = [n for n in sd_on if "running_" in n]
    assert stats
    for name in sd_on:
        assert torch.equal(sd_on[name], sd_off[name]), name
    init = SaliencyTrainer(on.model.config, device="cpu").init_state(seed=1)
    moved = [n for n in stats
             if not torch.equal(sd_on[n], init.model.state_dict()[n])]
    assert moved == stats


def test_decay_split_leaves_batch_norm_scales_out():
    """Weight decay on conv and dense kernels only, as the reference's
    ``_kernel_mask``: no batch-norm scale or bias is decayed."""
    cfg = brats_saliency_config(base_filter=4, instance_norm=False)
    model = SaliencyTrainer(cfg, device="cpu").init_state().model
    decayed, rest = decay_split(model)
    bn = [n for n, m in model.named_modules() if isinstance(m, BatchNorm)]
    assert bn
    for name in bn:
        assert f"{name}.weight" in rest and f"{name}.bias" in rest
    assert all(n.endswith(".weight") and ".BatchNorm_" not in n
               for n in decayed)
