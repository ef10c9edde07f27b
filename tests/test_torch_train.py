"""Port point-seg training (pointunet_tpu_torch/train/pointseg.py and what
it runs) against the reference trainer, on the CPU at small sizes.

Inputs are made with numpy from a seed and fed to both sides; where the
reference's gathers run ``sorted_gather``, its VJP on the CPU is XLA's
scatter, while the port's takes the sorted plan (the kernel's plain
version) above the size gate. Tolerances, all f32:

* batch norm (train mode): outputs and running statistics to 1e-5 and
  1e-6: f32 reductions in another order;
* losses: 1e-6 relative: the same per-point terms, summed in another
  order;
* the learning-rate schedule: equal to 1e-12 relative (both are Python
  float arithmetic); one Adam update: the step within 1e-4 relative (the
  same formula; optax forms the bias corrections 1 - b^t in f32, which
  at b2 = 0.999 and small t is off by up to ~3e-5 relative, torch in
  f64);
* one train step at 24,576 points (f32, no dropout, the reference's
  pyramid injected), held against the reference trainer's same step run
  in f64 from the same f32 weights and inputs: loss within 1e-5
  relative, every parameter gradient within 1e-4 x its max |g|, updated
  batch-norm statistics within 1e-5. (The reference's own f32 gradient
  is no sharper referee: against its f64 run it is off by up to 1.8e-4
  x max |g| on a level-0 batch-norm bias, a sum over 393,216 rows, where
  the port's f32 gradient is within 4.2e-6 x max |g| everywhere.) The Linear biases that feed a batch norm have
  a zero gradient analytically; there both sides must stay below 1e-6 of
  the model's largest gradient (their rounding noise is ~3e-7 of it).
"""
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from flax import traverse_util

from pointunet_tpu.core.config import brats_pointseg_config as jax_cfg
from pointunet_tpu.data.datasets import BraTSPointDataset as JaxBraTSDataset
from pointunet_tpu.models import losses as jax_losses
from pointunet_tpu.ops.pyramid import build_pyramid_batch as jax_build_pyramid
from pointunet_tpu.train import metrics as jax_metrics
from pointunet_tpu.train.pointseg import PointSegTrainer as JaxTrainer
from pointunet_tpu_torch.convert import convert_leaves, convert_train_state
from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
from pointunet_tpu_torch.core.config import brats_pointseg_config
from pointunet_tpu_torch.data.datasets import BraTSPointDataset
from pointunet_tpu_torch.data.prefetch import prefetch
from pointunet_tpu_torch.models import losses
from pointunet_tpu_torch.models.norms import BatchNorm
from pointunet_tpu_torch.ops import scatter_sorted as ss
from pointunet_tpu_torch.ops.pyramid import Pyramid
from pointunet_tpu_torch.train import metrics
from pointunet_tpu_torch.train.pointseg import (
    ADAM_BETAS,
    ADAM_EPS,
    PointSegTrainer,
    TrainState,
)
from torch_parity import named_to_flax_flat, to_torch, voxel_block
from util_synthetic import make_point_tree

torch.set_num_threads(1)

N_STEP = 24_576                    # a shuffled (32, 32, 24) voxel block
NARROW = (16, 32, 32, 32, 32)
# the Linear biases that feed a batch norm: fc0's and every SharedMLP's
BIAS_BEFORE_BN = re.compile(r"(^params|SharedMLP_\d+)/Dense_0/bias$")


def _labels(xyz: np.ndarray) -> np.ndarray:
    """Three shells of a ball in the middle of the cloud, background 0."""
    d = np.linalg.norm(xyz - 0.5, axis=-1)
    return np.select([d < 0.12, d < 0.2, d < 0.28], [3, 2, 1], 0).astype(np.int32)


def _cloud(rng, n_shape=(32, 32, 24)):
    xyz = voxel_block(n_shape, rng)
    feats = np.concatenate(
        [xyz, rng.standard_normal((len(xyz), 4)).astype(np.float32)], -1
    )
    return xyz[None], feats[None], _labels(xyz)[None]


def _flat_train_state(state) -> dict:
    """A reference TrainState -> the flat dict convert_train_state takes."""
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in traverse_util.flatten_dict(
            getattr(state, coll), sep="/"
        ).items():
            flat[f"{coll}/{k}"] = np.asarray(v)
    adam = state.opt_state[0]                 # optax ScaleByAdamState
    for which in ("mu", "nu"):
        for k, v in traverse_util.flatten_dict(
            getattr(adam, which), sep="/"
        ).items():
            flat[f"{which}/{k}"] = np.asarray(v)
    flat["count"] = np.asarray(adam.count)
    flat["step"] = np.asarray(state.step)
    return flat


def _port_state(flat, cfg) -> tuple:
    trainer = PointSegTrainer(cfg, device="cpu")
    state = trainer.init_state()
    state.load_state_dict(convert_train_state(flat, state.model))
    return trainer, state


# ------------------------------------------------------------------ #


@pytest.mark.parametrize("shape", [(2, 300, 6), (1, 50, 16, 6)])
def test_batchnorm_train_matches_flax(rng, shape):
    c = shape[-1]
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, c).astype(np.float32)
    bias = rng.standard_normal(c).astype(np.float32)
    mean0 = rng.standard_normal(c).astype(np.float32)
    var0 = rng.uniform(0.5, 2, c).astype(np.float32)
    flax_bn = nn.BatchNorm(use_running_average=False, momentum=0.99,
                           epsilon=1e-6)
    want, mutated = flax_bn.apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": {"mean": mean0, "var": var0}},
        jnp.asarray(x), mutable=["batch_stats"],
    )
    bn = BatchNorm(c, 1e-6, 0.99)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(scale))
        bn.bias.copy_(torch.from_numpy(bias))
        bn.running_mean.copy_(torch.from_numpy(mean0))
        bn.running_var.copy_(torch.from_numpy(var0))
    got = bn.train()(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=1e-5)
    stats = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(stats["var"]), atol=1e-6, rtol=1e-6)


def test_losses_match_reference(rng):
    ignored = (1,)
    num_classes = 3                          # labels 0..3, 1 is ignored
    logits = rng.standard_normal((2, 64, num_classes)).astype(np.float32) * 3
    labels = rng.integers(0, 4, (2, 64)).astype(np.int32)
    weights = (0.5, 2.0, 3.0)
    want = jax_losses.weighted_cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), weights, num_classes, ignored
    )
    want_grad = jax.grad(lambda z: jax_losses.weighted_cross_entropy(
        z, jnp.asarray(labels), weights, num_classes, ignored
    ))(jnp.asarray(logits))
    z = torch.from_numpy(logits).requires_grad_(True)
    got = losses.weighted_cross_entropy(
        z, torch.from_numpy(labels), weights, num_classes, ignored
    )
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-7)
    # the mean runs over the count of valid points, not the weights' sum
    valid = labels != 1
    assert got.item() != pytest.approx(float(torch.nn.functional.cross_entropy(
        torch.from_numpy(logits[valid]),
        torch.from_numpy(np.array([0, 0, 1, 2])[labels[valid]]),
        weight=torch.tensor(weights),
    )))

    lab4 = rng.integers(0, 4, (2, 64))
    logits4 = rng.standard_normal((2, 64, 4)).astype(np.float32)
    for jf, tf, args in (
        (jax_losses.point_dice_loss, losses.point_dice_loss, (4,)),
        (jax_losses.point_dice_weighted, losses.point_dice_weighted, ()),
    ):
        want = jf(jnp.asarray(logits4), jnp.asarray(lab4), *args)
        got = tf(torch.from_numpy(logits4), torch.from_numpy(lab4), *args)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_lr_schedule_matches_reference():
    cfg = dict(num_points=1024, train_steps=7, learning_rate=1e-3,
               lr_decay=0.9)
    ref = JaxTrainer(jax_cfg(**cfg))
    port = PointSegTrainer(brats_pointseg_config(**cfg), device="cpu")
    for step in (0, 1, 6, 7, 8, 13, 14, 15, 70, 700):
        np.testing.assert_allclose(
            port.lr_at(step), float(ref._lr_schedule(step)), rtol=1e-12
        )


def test_adam_updates_match_optax(rng):
    """Three updates across an epoch boundary (train_steps=2), through
    the trainer's ``apply_update`` and the reference's optax chain."""
    cfg = dict(num_points=1024, train_steps=2, learning_rate=1e-2,
               lr_decay=0.5)
    tx = JaxTrainer(jax_cfg(**cfg)).tx
    trainer = PointSegTrainer(brats_pointseg_config(**cfg), device="cpu")
    # Adam's step does not depend on the parameters: each update starts
    # from zeros, so the new values are the step rounded once
    p = torch.nn.Parameter(torch.zeros(5, 3))
    state = TrainState(
        None, torch.optim.Adam([p], betas=ADAM_BETAS, eps=ADAM_EPS), 0, None
    )
    opt_state = tx.init({"w": jnp.zeros((5, 3))})
    for _ in range(3):
        g = rng.standard_normal((5, 3)).astype(np.float32)
        with torch.no_grad():
            p.zero_()
        p.grad = torch.from_numpy(g)
        trainer.apply_update(state)
        updates, opt_state = tx.update({"w": jnp.asarray(g)}, opt_state)
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(updates["w"]),
                                   rtol=1e-4, atol=1e-10)
    assert state.step == 3


@pytest.fixture(scope="module")
def step_reference():
    """The reference trainer's state and pyramid at 24,576 points, and its
    loss, gradients and updated batch statistics of one train step,
    computed in f64 from the same f32 weights and inputs."""
    cfg = jax_cfg(num_points=N_STEP, d_out=NARROW, dropout_rate=0.0,
                  use_bfloat16=False)
    trainer = JaxTrainer(cfg)
    state = trainer.init_state(seed=0)
    xyz, feats, labels = _cloud(np.random.default_rng(7))
    pyr = jax.jit(lambda p: jax_build_pyramid(
        p, cfg.k_n, cfg.sub_sampling_ratio
    ))(jnp.asarray(xyz))
    flat = _flat_train_state(state)
    with jax.enable_x64(True):
        f64 = lambda a: jnp.asarray(np.asarray(a), jnp.float64)  # noqa: E731
        order = pyr.order
        pyr64 = pyr._replace(xyz=tuple(f64(x) for x in pyr.xyz))
        f_s = jnp.take_along_axis(f64(feats), order[..., None], 1)
        l_s = jnp.take_along_axis(jnp.asarray(labels), order, 1)
        grad_fn = jax.jit(jax.value_and_grad(trainer._loss_fn, has_aux=True))
        (loss, (batch_stats, _)), grads = grad_fn(
            jax.tree_util.tree_map(f64, state.params),
            jax.tree_util.tree_map(f64, state.batch_stats),
            state.rng, pyr64, f_s, l_s,
        )
        out = {
            "loss": float(loss),
            "grads": {f"params/{k}": np.asarray(v) for k, v in
                      traverse_util.flatten_dict(grads, sep="/").items()},
            "batch_stats": {
                f"batch_stats/{k}": np.asarray(v) for k, v in
                traverse_util.flatten_dict(batch_stats, sep="/").items()
            },
        }
    return dict(out, flat=flat, pyr=pyr, feats=feats, labels=labels)


def test_train_step_matches_reference(step_reference, monkeypatch):
    ref = step_reference
    cfg = brats_pointseg_config(num_points=N_STEP, d_out=NARROW,
                                dropout_rate=0.0, use_bfloat16=False)
    trainer, state = _port_state(ref["flat"], cfg)
    planned = []
    plain = ss.scatter_sorted_plain
    monkeypatch.setattr(
        ss, "scatter_sorted_plain", lambda *a: planned.append(a) or plain(*a)
    )
    pyr = Pyramid(*to_torch(ref["pyr"]))
    state, m = trainer.train_core(
        state, pyr, torch.from_numpy(ref["feats"]),
        torch.from_numpy(ref["labels"]).long(),
    )
    # level 0 (24,576 > GRID_THRESHOLD points) takes the planned path for
    # its two self gathers (393,216 rows each), with no gate lowered
    assert [a[0].shape[0] for a in planned] == [N_STEP * 16] * 2
    np.testing.assert_allclose(float(m["loss"]), ref["loss"], rtol=1e-5)
    grads = named_to_flax_flat(
        {n: p.grad for n, p in state.model.named_parameters()}
    )
    assert set(grads) == set(ref["grads"])
    top = max(float(np.abs(g).max()) for g in ref["grads"].values())
    for key, want in ref["grads"].items():
        if BIAS_BEFORE_BN.search(key):
            # zero analytically (a train-mode batch norm removes any
            # shift): both sides hold rounding noise only
            assert float(np.abs(want).max()) < 1e-6 * top, key
            assert float(np.abs(grads[key]).max()) < 1e-6 * top, key
            continue
        bound = 1e-4 * float(np.abs(want).max())
        np.testing.assert_allclose(grads[key], want, rtol=0, atol=bound,
                                   err_msg=key)
    stats = named_to_flax_flat(
        {n: b for n, b in state.model.named_buffers()}
    )
    for key, want in ref["batch_stats"].items():
        np.testing.assert_allclose(stats[key], want, atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    assert state.step == 1


def test_convert_train_state_round_trips(rng):
    """A reference state after one update -> the port's; the tensors come
    back in the reference's layout unchanged, and the next update with
    the same gradient moves both sides alike (Adam's moments and count
    carried over)."""
    n = 1024
    cfg = dict(num_points=n, d_out=NARROW, dropout_rate=0.0,
               use_bfloat16=False)
    ref = JaxTrainer(jax_cfg(**cfg))
    state = ref.init_state(seed=1)
    # one optax update with random gradients gives non-zero moments
    g0 = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        state.params,
    )
    _, opt_state = ref.tx.update(g0, state.opt_state)
    state = state._replace(opt_state=opt_state, step=state.step + 1)
    flat = _flat_train_state(state)
    assert int(flat["count"]) == 1 and int(flat["step"]) == 1
    trainer, port = _port_state(flat, brats_pointseg_config(**cfg))
    assert port.step == 1
    back = named_to_flax_flat(port.model.state_dict())
    for key, want in flat.items():
        if key.startswith(("params/", "batch_stats/")):
            np.testing.assert_array_equal(back[key], want, err_msg=key)
    opt = port.optimizer.state_dict()["state"]
    names = [name for name, _ in port.model.named_parameters()]
    for which, slot in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        moments = named_to_flax_flat(
            {name: opt[i][slot] for i, name in enumerate(names)}
        )
        for key, arr in moments.items():
            np.testing.assert_array_equal(
                arr, flat[f"{which}/" + key.split("/", 1)[1]], err_msg=key
            )
    assert all(float(opt[i]["step"]) == 1.0 for i in range(len(names)))

    # one more update with one gradient on both sides
    grads = {k[len("params/"):]: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in flat.items() if k.startswith("params/")}
    updates, _ = ref.tx.update(
        traverse_util.unflatten_dict(
            {tuple(k.split("/")): jnp.asarray(v) for k, v in grads.items()}
        ),
        state.opt_state,
    )
    want = {f"params/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(updates, sep="/").items()}
    params = dict(port.model.named_parameters())
    port_grads = convert_leaves(
        {f"params/{k}": v for k, v in grads.items()}, params
    )
    for name, p in params.items():
        with torch.no_grad():
            p.zero_()              # the step does not depend on the values
        p.grad = port_grads[name]
    trainer.apply_update(port)
    moved = named_to_flax_flat(
        {n: p.detach() for n, p in params.items()}
    )
    for key, w in want.items():
        np.testing.assert_allclose(moved[key], w, rtol=1e-4, atol=1e-10,
                                   err_msg=key)


def test_eval_step_returns_callers_order(rng):
    cfg = brats_pointseg_config(num_points=2048, d_out=NARROW)
    trainer = PointSegTrainer(cfg, device="cpu")
    state = trainer.init_state()
    xyz, feats, _ = _cloud(rng, (16, 16, 8))
    probs = trainer.eval_step(state, xyz, feats)
    assert probs.shape == (1, 2048, 4)
    pyr = trainer.pyramid_fn(torch.from_numpy(xyz))
    order = pyr.order.long()[0]
    with torch.no_grad():
        sorted_feats = torch.from_numpy(feats)[:, order]
        want = torch.softmax(state.model.eval()(sorted_feats, pyr), -1)
    torch.testing.assert_close(probs[0, order], want[0], rtol=0, atol=0)
    torch.testing.assert_close(probs.sum(-1), torch.ones(1, 2048))


def test_loss_descends_on_a_toy_cloud(rng):
    cfg = brats_pointseg_config(num_points=2048, d_out=NARROW,
                                learning_rate=1e-2, dropout_rate=0.0)
    trainer = PointSegTrainer(cfg, device="cpu")
    state = trainer.init_state()
    xyz, feats, labels = _cloud(rng, (16, 16, 8))
    feats[..., 3:] += labels[..., None]          # separable by intensity
    seen = []
    for _ in range(12):
        state, m = trainer.train_step(state, xyz, feats, labels)
        seen.append(float(m["loss"]))
    assert all(np.isfinite(seen))
    assert np.mean(seen[-3:]) < 0.5 * seen[0], seen


def test_dataset_matches_reference(tmp_path, rng):
    root = make_point_tree(str(tmp_path), ["c_a", "c_b", "c_c"], rng=rng)
    kw = dict(train_ids=["c_a", "c_b"], val_ids=["c_c"])
    ref = JaxBraTSDataset(root, config=jax_cfg(num_points=512), **kw)
    port = BraTSPointDataset(root, config=brats_pointseg_config(num_points=512),
                             **kw)
    assert port.files == ref.files
    for name in ("train_iter", "val_iter", "test_iter"):
        got = list(getattr(port, name)())
        want = list(getattr(ref, name)())
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                if isinstance(b, str):
                    assert a == b
                else:
                    assert a.dtype == b.dtype
                    np.testing.assert_array_equal(a, b)


def test_metrics_match_reference(rng):
    lab = rng.integers(0, 4, 500)
    pred = np.where(rng.uniform(size=500) < 0.7, lab, rng.integers(0, 4, 500))
    pred[pred == 3] = 2                         # one class never predicted
    conf = metrics.confusion_matrix(lab, pred, 4)
    np.testing.assert_array_equal(conf, jax_metrics.confusion_matrix(lab, pred, 4))
    np.testing.assert_array_equal(metrics.iou_from_confusion(conf),
                                  jax_metrics.iou_from_confusion(conf))
    assert metrics.mean_iou(lab, pred, 4) == jax_metrics.mean_iou(lab, pred, 4)
    np.testing.assert_array_equal(metrics.per_class_dice(pred, lab, 4),
                                  jax_metrics.per_class_dice(pred, lab, 4))


def test_checkpointer_keeps_latest_and_pins_best(tmp_path):
    cfg = brats_pointseg_config(num_points=1024, d_out=NARROW)
    trainer = PointSegTrainer(cfg, device="cpu")
    state = trainer.init_state()
    ck = BestMetricCheckpointer(str(tmp_path), max_to_keep=2)
    ref = {k: v.clone() for k, v in state.model.state_dict().items()}
    ck.save(state, 1, metric=0.5)               # best
    with torch.no_grad():
        for p in state.model.parameters():
            p.add_(1.0)
    state.step = 5
    for step in (2, 3, 4):
        ck.save(state, step)
    assert sorted(os.listdir(tmp_path)) == ["3.pt", "4.pt", "best", "best.json"]
    assert ck.latest_step() == 4 and ck.best_step() == 1
    fresh = trainer.init_state(seed=3)
    assert ck.restore_latest(fresh) is fresh and fresh.step == 5
    ck.restore_best(fresh)
    assert fresh.step == 0                       # the state saved as step 1
    for k, v in fresh.model.state_dict().items():
        torch.testing.assert_close(v, ref[k], rtol=0, atol=0)
    assert BestMetricCheckpointer(str(tmp_path / "none")).restore_latest(
        fresh) is None


def test_prefetch_keeps_order_and_raises():
    assert list(prefetch(iter(range(20)), 3)) == list(range(20))

    def broken():
        yield 1
        raise ValueError("bad batch")

    it = prefetch(broken(), 2)
    assert next(it) == 1
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


def test_run_brats_train_then_test_on_cpu(tmp_path, rng):
    from pointunet_tpu_torch.cli import run_brats

    root = make_point_tree(str(tmp_path / "pc"), ["c1", "c2"], rng=rng)
    (tmp_path / "tr.txt").write_text("c1\n")
    (tmp_path / "va.txt").write_text("c2\n")
    logdir = tmp_path / "logs"
    common = ["--data_PC_path", root, "--train_ids", str(tmp_path / "tr.txt"),
              "--val_ids", str(tmp_path / "va.txt"), "--logdir", str(logdir),
              "--n_point", "1024", "--device", "cpu"]
    state = run_brats.main(["--mode", "train", "--n_epoch", "2"] + common)
    assert state.step == 2
    assert (logdir / "snapshots" / "best.json").exists()
    assert (logdir / "scalars.jsonl").exists()
    results = tmp_path / "npy"
    run_brats.main(["--mode", "test", "--results_path", str(results),
                    "--volume_shape", "32", "32", "32"] + common)
    vol = np.load(results / "c2.npy")
    assert vol.shape == (32, 32, 32, 4) and vol.dtype == np.float32
    filled = vol.sum(-1)
    np.testing.assert_allclose(filled[filled > 0], 1.0, rtol=1e-5)
