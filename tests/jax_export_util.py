"""Shared by the checkpoint-bridge tests (tests/test_torch_checkpoint_bridge.py,
tests/test_torch_saliency_bridge.py): reference states advanced and
saved by the JAX package, their logits, the port's, the comparisons, and
``make_fixture``, which wrote ``tests/fixtures/jax_export/``:

    JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests'];
        import jax_export_util as u; u.make_fixture('tests/fixtures/jax_export')"
"""
import functools
import json
import os
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

REPO = Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

import export_jax_checkpoint  # noqa: E402
from pointunet_tpu.core import config as ref_config  # noqa: E402
from pointunet_tpu.core.checkpoint import (  # noqa: E402
    BestMetricCheckpointer as RefCheckpointer,
)
from pointunet_tpu.train.pointseg import PointSegTrainer as RefPointTrainer  # noqa: E402
from pointunet_tpu.train.saliency import SaliencyTrainer as RefSalTrainer  # noqa: E402
from pointunet_tpu_torch.core import config as port_config  # noqa: E402
from pointunet_tpu_torch.ops.pyramid import take_level0  # noqa: E402
from pointunet_tpu_torch.train.pointseg import PointSegTrainer  # noqa: E402
from torch_parity import named_to_flax_flat  # noqa: E402

FIXTURE = REPO / "tests" / "fixtures" / "jax_export"
N_POINT = 1024
# one train step an epoch, no evaluation inside ``fit``
TINY = dict(base_filter=4, patch_size=(16, 32, 32),
            inference_patch_size=(16, 32, 32), xstep=8, ystep=16, zstep=16,
            steps_per_epoch=1, max_epoch=1, eval_epoch=1000)
SALIENCY_BAR = dict(atol=3e-4, rtol=1e-4)
MOMENT_BAR = dict(atol=1e-6, rtol=0)
# the fixture's nets (tests/fixtures/jax_export/meta.json records them)
FIXTURE_POINTSEG = dict(num_points=1024, d_out=(4, 4, 4, 4, 4),
                        use_bfloat16=False)
FIXTURE_SALIENCY = dict(base_filter=1, depth=3, instance_norm=False,
                        patch_size=(8, 16, 16), inference_patch_size=(8, 16, 16))


def cloud(n, seed):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 1, (1, n, 3)).astype(np.float32)
    feats = np.concatenate(
        [xyz, rng.standard_normal((1, n, 4)).astype(np.float32)], -1)
    labels = rng.integers(0, 4, (1, n)).astype(np.int32)
    return xyz, feats, labels


@functools.lru_cache(maxsize=None)
def jitted(trainer, name):
    """One compiled function a reference trainer: its eval forward
    (``point``, ``saliency``), the saliency net's train-mode forward
    (``saliency_train``) or its optimizer's update (``update``)."""
    if name == "update":
        def update(grads, opt_state, params):
            updates, opt_state = trainer.tx.update(grads, opt_state, params)
            return optax.apply_updates(params, updates), opt_state

        return jax.jit(update)
    if name == "point":
        return jax.jit(lambda v, f, p: trainer.model.apply(
            v, f, p, train=False))
    return jax.jit(lambda p, b, x: trainer._apply(
        p, b, x, name == "saliency_train"))


def ref_point_logits(trainer, state, xyz, feats) -> np.ndarray:
    """Reference eval logits (B, N, C) in the caller's row order."""
    pyr = trainer.pyramid_fn(jnp.asarray(xyz))
    f = jnp.take_along_axis(jnp.asarray(feats), pyr.order[..., None], 1)
    logits = jitted(trainer, "point")(
        {"params": state.params, "batch_stats": state.batch_stats}, f, pyr)
    inv = np.argsort(np.asarray(pyr.order), -1)
    return np.take_along_axis(np.asarray(logits), inv[..., None], 1)


def port_point_logits(model, cfg, xyz, feats, device="cpu") -> np.ndarray:
    trainer = PointSegTrainer(cfg, device=device)
    with torch.no_grad():
        pyr = trainer.pyramid_fn(torch.from_numpy(xyz).to(device))
        f = take_level0(pyr, torch.from_numpy(feats).to(device))
        logits = model.eval()(f, pyr)
    inv = torch.argsort(pyr.order.long(), dim=-1)
    return logits.gather(1, inv[..., None].expand_as(logits)).cpu().numpy()


def assert_point_logits(got, want):
    np.testing.assert_allclose(
        got, want, rtol=0, atol=1e-4 * max(1.0, float(np.abs(want).max())))


def ref_saliency_logits(trainer, state, x) -> np.ndarray:
    """Reference eval logits of a (B, D, H, W, C) batch, channels last."""
    logits, _ = jitted(trainer, "saliency")(
        state.params, state.batch_stats, jnp.asarray(x))
    return np.asarray(logits)


def port_saliency_logits(model, x, device="cpu") -> np.ndarray:
    with torch.no_grad():
        out = model.eval()(
            torch.from_numpy(x).permute(0, 4, 1, 2, 3).contiguous().to(device))
    return out.permute(0, 2, 3, 4, 1).cpu().numpy()


def advance(trainer, state, steps, seed, images=None):
    """``steps`` updates of the reference's own optimizer on seeded
    gradients, the batch-norm statistics from its train-mode forward on
    ``images`` when the net has them; step and counts advance as a train
    step advances them."""
    rng = np.random.default_rng(seed)
    params, opt_state, batch_stats = state.params, state.opt_state, \
        state.batch_stats
    for _ in range(steps):
        if images is not None and jax.tree_util.tree_leaves(batch_stats):
            _, batch_stats = jitted(trainer, "saliency_train")(
                params, batch_stats, jnp.asarray(images))
        grads = jax.tree_util.tree_map(
            lambda p: jnp.asarray(
                rng.standard_normal(p.shape).astype(np.float32) * 0.1),
            params)
        params, opt_state = jitted(trainer, "update")(
            grads, opt_state, params)
    return type(state)(params, batch_stats, opt_state, state.step + steps,
                       state.rng)


def saliency_cfg(cls_cfg, instance_norm, **kw):
    return cls_cfg(**{**TINY, "instance_norm": instance_norm, **kw})


def assert_point_state(port_state, ref_state):
    """The port's restored Adam moments and step against the reference
    state's."""
    adam = ref_state.opt_state[0]
    assert port_state.step == int(ref_state.step)
    opt = port_state.optimizer
    for which, key in (("mu", "exp_avg"), ("nu", "exp_avg_sq")):
        got = named_to_flax_flat({
            name: opt.state[p][key]
            for name, p in port_state.model.named_parameters()})
        want = export_jax_checkpoint._flat(getattr(adam, which), "params")
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **MOMENT_BAR,
                                       err_msg=k)
    for p in port_state.model.parameters():
        assert float(opt.state[p]["step"]) == int(adam.count)


def assert_saliency_state(port_state, ref_state):
    trace, sched = ref_state.opt_state[1]
    assert port_state.step == int(ref_state.step) == int(sched.count)
    opt = port_state.optimizer
    got = named_to_flax_flat({
        name: opt.state[p]["momentum_buffer"]
        for name, p in port_state.model.named_parameters()})
    want = export_jax_checkpoint._flat(trace.trace, "params")
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **MOMENT_BAR, err_msg=k)
    stats = {n: t for n, t in port_state.model.state_dict().items()
             if "running_" in n}
    want = export_jax_checkpoint._flat(ref_state.batch_stats, "batch_stats")
    assert len(stats) == len(want)
    for k, v in named_to_flax_flat(stats).items():
        np.testing.assert_allclose(v, want[k], **MOMENT_BAR, err_msg=k)


def fixture_configs(meta):
    pcfg = port_config.brats_pointseg_config(
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in meta["pointseg"].items()})
    scfg = port_config.brats_saliency_config(
        **{k: tuple(v) if isinstance(v, list) else v
           for k, v in meta["saliency"].items()})
    return pcfg, scfg


def make_fixture(out_dir: str) -> None:
    """Write ``tests/fixtures/jax_export``: reference states of the narrow
    point net (two train steps) and the narrow batch-norm ``UNet3D`` (two
    seeded updates, saved as best), exported, with seeded inputs and the
    reference's logits (an export has one file of ~660 entries a point-net
    state, so only the smaller net's best slot is kept)."""
    import shutil
    import tempfile

    out = Path(out_dir)
    pcfg = ref_config.brats_pointseg_config(**FIXTURE_POINTSEG)
    scfg = ref_config.brats_saliency_config(**FIXTURE_SALIENCY)
    xyz, feats, labels = cloud(FIXTURE_POINTSEG["num_points"], 7)
    x = np.random.default_rng(8).standard_normal(
        (1,) + FIXTURE_SALIENCY["patch_size"] + (4,)).astype(np.float32)
    pt = RefPointTrainer(pcfg)
    pstate = pt.init_state(seed=7)
    for _ in range(2):
        pstate, _ = pt.train_step(pstate, xyz, feats, labels)
    st = RefSalTrainer(scfg, attention=False)
    sstate = advance(st, st.init_state(seed=8), 2, seed=8, images=x)
    with tempfile.TemporaryDirectory() as tmp:
        for name, trainer, state, metric in (
                ("pointseg", pt, pstate, None), ("saliency", st, sstate, 0.5)):
            ckpt = RefCheckpointer(os.path.join(tmp, name))
            ckpt.save(jax.tree_util.tree_map(np.asarray, state), 2, metric)
            ckpt.close()
            shutil.rmtree(out / name, ignore_errors=True)
            export_jax_checkpoint.export(
                os.path.join(tmp, name), str(out / name),
                trainer.init_state(), name)
    np.savez_compressed(out / "inputs.npz", point_feats=feats,
             point_logits=ref_point_logits(pt, pstate, xyz, feats),
             saliency_x=x, saliency_logits=ref_saliency_logits(st, sstate, x))
    meta = {"pointseg": FIXTURE_POINTSEG, "saliency": FIXTURE_SALIENCY,
            "saliency_net": "unet3d", "steps": 2,
            "jax": jax.__version__}
    (out / "meta.json").write_text(json.dumps(meta, indent=1) + "\n")
