"""Saliency-net checkpoints that the JAX package wrote, read by the port
(tests/test_torch_checkpoint_bridge.py has the point net's, the
exporter's layout and the refusals): ``SaliencyUNet`` at ``base_filter``
4, patch (16, 32, 32), in its instance-norm and batch-norm flavours. The
reference's init state is advanced twice by the reference's optimizer
(weight decay masked to the kernels, then momentum SGD) on seeded
gradients and, for batch norm, by the batch statistics of its train-mode
forward (the reference's jitted saliency step takes ~20 s a step on a
CPU; tests/test_torch_saliency_step.py holds the port's step to it);
saved by the reference's orbax ``BestMetricCheckpointer`` (best at step
1, latest at step 2) and exported. ``segment``, ``serve`` and
``train_attention`` restore the export.

Bars: logits within atol 3e-4, rtol 1e-4 (tests/test_torch_saliency.py's
bar: the variance in another form, conv sums in another order); SGD
momentum buffers and batch-norm statistics within 1e-6 (the same f32
values, transposed); the step carried over exactly.
"""
import os

import jax
import numpy as np
import pytest
import torch

from jax_export_util import (
    N_POINT,
    SALIENCY_BAR,
    RefCheckpointer,
    RefSalTrainer,
    advance,
    assert_saliency_state,
    export_jax_checkpoint,
    port_saliency_logits,
    ref_config,
    ref_saliency_logits,
    saliency_cfg,
)
from pointunet_tpu_torch.cli import segment, serve, train_attention
from pointunet_tpu_torch.core import config as port_config
from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
from pointunet_tpu_torch.train.saliency import SaliencyTrainer
from util_synthetic import make_brats_case

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[True, False],
                ids=["instance_norm", "batch_norm"])
def saliency_run(request, tmp_path_factory):
    """The reference saliency state of one norm flavour, advanced twice,
    saved (best at step 1, latest at step 2) and exported."""
    inorm = request.param
    root = tmp_path_factory.mktemp("saliency_bridge")
    cfg = saliency_cfg(ref_config.brats_saliency_config, inorm)
    trainer = RefSalTrainer(cfg)
    state = trainer.init_state(seed=2)
    rng = np.random.default_rng(2)
    images = rng.standard_normal((1, 16, 32, 32, 4)).astype(np.float32)
    ckpt = RefCheckpointer(str(root / "orbax"))
    states = {}
    for step in (1, 2):
        state = advance(trainer, state, 1, seed=step, images=images)
        states[step] = jax.tree_util.tree_map(np.asarray, state)
        ckpt.save(states[step], step, metric=0.5 if step == 1 else None)
    ckpt.close()
    counts = export_jax_checkpoint.export(      # any state of the net is
        str(root / "orbax"), str(root / "export"), states[1],  # a template
        "saliency")
    assert counts == {"steps": 2, "best": 1}
    return dict(root=root, trainer=trainer, states=states, images=images,
                inorm=inorm)


def test_segment_and_serve_restore_the_saliency_net(saliency_run, tmp_path,
                                                    monkeypatch):
    out = str(saliency_run["root"] / "export")
    inorm = saliency_run["inorm"]
    monkeypatch.setattr(
        segment, "brats_saliency_config",
        lambda **kw: saliency_cfg(port_config.brats_saliency_config, inorm,
                                   **kw))
    want = ref_saliency_logits(saliency_run["trainer"],
                                saliency_run["states"][1],
                                saliency_run["images"])
    args = dict(dataset="brats", fast=False, sa_stride=None, n_point=N_POINT,
                pointseg_checkpoint=None, saliency_checkpoint=out)
    import argparse

    p = segment.build_pipeline(argparse.Namespace(**args))
    assert not p.saliency_model.training
    got = port_saliency_logits(p.saliency_model, saliency_run["images"])
    np.testing.assert_allclose(got, want, **SALIENCY_BAR)
    (tmp_path / "in").mkdir()
    server = serve.main(["--inbox", str(tmp_path / "in"), "--outbox",
                         str(tmp_path / "out"), "--once", "--device", "cpu",
                         "--n_point", str(N_POINT),
                         "--saliency_checkpoint", out])
    served = server.pipeline.saliency_model.state_dict()
    for name, t in p.saliency_model.state_dict().items():
        assert torch.equal(served[name], t), name


def test_train_attention_resumes_and_evaluates_from_the_export(
        saliency_run, tmp_path, monkeypatch, capsys):
    """The latest snapshot (step 2) loads with the reference's momentum
    trace and batch statistics; ``train_attention`` resumes from it (step
    2 -> 3) and ``--evaluate`` restores the best one."""
    out = saliency_run["root"] / "export"
    inorm = saliency_run["inorm"]
    cfg = saliency_cfg(port_config.brats_saliency_config, inorm)
    state = SaliencyTrainer(cfg, device="cpu").init_state()
    BestMetricCheckpointer(str(out)).restore_latest(state)
    assert_saliency_state(state, saliency_run["states"][2])
    np.testing.assert_allclose(
        port_saliency_logits(state.model, saliency_run["images"]),
        ref_saliency_logits(saliency_run["trainer"],
                             saliency_run["states"][2],
                             saliency_run["images"]), **SALIENCY_BAR)

    monkeypatch.setattr(
        train_attention, "brats_saliency_config",
        lambda: saliency_cfg(port_config.brats_saliency_config, inorm))
    rng = np.random.default_rng(6)
    for case in ("c0", "c1"):
        make_brats_case(str(tmp_path / "cases"), case, rng=rng)
    ckpt = tmp_path / "ckpt"
    os.makedirs(ckpt / "best")
    for name in ("1.npz", "2.npz", "best.json", "best/1.npz"):
        os.link(out / name, ckpt / name)
    common = ["--basedir", str(tmp_path / "cases"), "--logdir",
              str(tmp_path / "logs"), "--device", "cpu",
              "--checkpoint_path", str(ckpt)]
    best = train_attention.main(common + ["--evaluate"])
    assert best.step == 1
    resumed = train_attention.main(common)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == 3


