"""Checkpoints that the JAX package wrote, read by the port: the
reference's orbax ``BestMetricCheckpointer`` writes train states,
``export_jax_checkpoint.py`` (repo root) exports them, and the port's
CLIs restore them: here the point net's through ``segment``'s
``_restore``, ``serve``, ``run_brats`` and ``run_pancreas``, the
exporter's layout, the refusals and the committed fixture
(tests/test_torch_saliency_bridge.py has the saliency net's through
``segment``, ``serve`` and ``train_attention``). On the CPU at small
sizes, inputs made by numpy from a seed.

The states: the BraTS config at full width after two of the reference
trainer's own train steps at 1,024 points (best at step 1, latest at
step 2); the Pancreas config's init state after one Adam update of the
reference's optimizer on seeded gradients.

Bars: point-net logits within 1e-4 x max(1, max |logit|) (f32 sums in
another order: tests/test_torch_randlanet.py's 1e-4 at the init's logits,
|logit| ~1; two Adam steps at lr 0.01 with the running statistics still
near their init give logits up to ~130, where 1e-4 is ~7 ulps); Adam
moments within 1e-6 (the same f32 values, transposed); the step carried
over exactly.

The committed fixture ``tests/fixtures/jax_export/`` holds what the
exporter wrote from a narrow point net (d_out (4, 4, 4, 4, 4), 1,024
points, two reference train steps) and a narrow batch-norm ``UNet3D``
(``base_filter`` 1, depth 3, two seeded updates, saved as best; a
``SaliencyUNet`` has fixed widths of 64 to 384 channels, over 2 million
parameters, 8 MB in f32, where the fixture may take 512 KB), with seeded
inputs and the JAX logits recorded beside them (``inputs.npz``; the
saliency logits at its bar, atol 3e-4 and rtol 1e-4). It was made by

    JAX_PLATFORMS=cpu python -c "import sys; sys.path[:0] = ['.', 'tests'];
        import jax_export_util as u; u.make_fixture('tests/fixtures/jax_export')"

and ``chip_smoke.py`` phase ``bridge`` holds the card to it too.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

from jax_export_util import (
    FIXTURE,
    N_POINT,
    SALIENCY_BAR,
    RefCheckpointer,
    RefPointTrainer,
    advance,
    assert_point_logits,
    assert_point_state,
    cloud,
    export_jax_checkpoint,
    fixture_configs,
    port_point_logits,
    port_saliency_logits,
    ref_config,
    ref_point_logits,
)
from pointunet_tpu_torch import convert
from pointunet_tpu_torch.cli import (
    data_prepare_pancreas,
    run_brats,
    run_pancreas,
    segment,
    serve,
)
from pointunet_tpu_torch.core import config as port_config
from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer
from pointunet_tpu_torch.data import nifti
from pointunet_tpu_torch.train.pointseg import PointSegTrainer
from pointunet_tpu_torch.train.saliency import SaliencyTrainer
from util_synthetic import make_point_tree

torch.set_num_threads(1)


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def point_run(tmp_path_factory):
    """Two reference train steps at the BraTS config, saved by the
    reference (best at step 1, latest at step 2) and exported by the
    exporter's CLI."""
    root = tmp_path_factory.mktemp("point_bridge")
    cfg = ref_config.brats_pointseg_config(num_points=N_POINT)
    trainer = RefPointTrainer(cfg)
    state = trainer.init_state(seed=1)
    xyz, feats, labels = cloud(N_POINT, 1)
    ckpt = RefCheckpointer(str(root / "orbax"))
    states = {}
    for step in (1, 2):
        state, _ = trainer.train_step(state, xyz, feats, labels)
        states[step] = jax.tree_util.tree_map(np.asarray, state)
        ckpt.save(states[step], step, metric=0.5 if step == 1 else None)
    ckpt.close()
    export_jax_checkpoint.main([
        "--src", str(root / "orbax"), "--out", str(root / "export"),
        "--stage", "pointseg"])
    return dict(root=root, trainer=trainer, states=states, xyz=xyz,
                feats=feats)


# ------------------------------------------------------------ the exporter


def test_export_layout(point_run):
    out = point_run["root"] / "export"
    assert sorted(os.listdir(out)) == ["1.npz", "2.npz", "best", "best.json"]
    assert os.listdir(out / "best") == ["1.npz"]
    assert json.loads((out / "best.json").read_text())["step"] == 1
    with np.load(out / "2.npz", allow_pickle=False) as z:
        keys = set(z.files)
        assert int(z["step"]) == 2 and int(z["count"]) == 2
    heads = {k.split("/")[0] for k in keys}
    assert heads == {"params", "batch_stats", "mu", "nu", "count", "step",
                     "rng"}


def test_split_state_drops_rng_and_refuses_the_rest(point_run):
    with np.load(point_run["root"] / "export" / "2.npz") as z:
        flat = {k: z[k] for k in z.files}
    model = PointSegTrainer(port_config.brats_pointseg_config(
        num_points=N_POINT), device="cpu").init_state().model
    convert.convert_train_state(flat, model)
    with pytest.raises(KeyError, match="unconvertible train-state entry"):
        convert.convert_train_state(dict(flat, foo=np.zeros(1)), model)


# ------------------------------------------------------------ point net


def test_segment_and_serve_restore_the_point_net(point_run, tmp_path):
    """``segment``'s ``_restore`` and ``serve`` take the exported best
    snapshot (step 1): logits equal the reference's."""
    out = str(point_run["root"] / "export")
    want = ref_point_logits(point_run["trainer"], point_run["states"][1],
                             point_run["xyz"], point_run["feats"])
    cfg = port_config.brats_pointseg_config(num_points=N_POINT)
    model = segment._restore(out, PointSegTrainer(cfg, device="cpu"))
    got = port_point_logits(model, cfg, point_run["xyz"], point_run["feats"])
    assert_point_logits(got, want)
    (tmp_path / "in").mkdir()
    server = serve.main(["--inbox", str(tmp_path / "in"), "--outbox",
                         str(tmp_path / "out"), "--once", "--device", "cpu",
                         "--n_point", str(N_POINT),
                         "--pointseg_checkpoint", out])
    served = server.pipeline.pointseg_model.state_dict()
    for name, t in model.state_dict().items():
        assert torch.equal(served[name], t), name


def test_run_brats_resumes_and_tests_from_the_export(point_run, tmp_path,
                                                     capsys):
    """The latest snapshot (step 2) resumes with the reference's Adam
    moments; training goes on from step 2; test mode restores the best."""
    out = str(point_run["root"] / "export")
    cfg = port_config.brats_pointseg_config(num_points=N_POINT)
    trainer = PointSegTrainer(cfg, device="cpu")
    state = trainer.init_state()
    assert BestMetricCheckpointer(out).restore_latest(state) is state
    assert_point_state(state, point_run["states"][2])
    want = ref_point_logits(point_run["trainer"], point_run["states"][2],
                             point_run["xyz"], point_run["feats"])
    got = port_point_logits(state.model, cfg, point_run["xyz"],
                             point_run["feats"])
    assert_point_logits(got, want)

    ckpt = tmp_path / "ckpt"
    ckpt.mkdir()
    for name in ("1.npz", "2.npz", "best.json"):
        os.link(os.path.join(out, name), ckpt / name)
    (ckpt / "best").mkdir()
    os.link(os.path.join(out, "best", "1.npz"), ckpt / "best" / "1.npz")
    root = make_point_tree(str(tmp_path / "pc"), ["c1", "c2"],
                           rng=np.random.default_rng(0))
    (tmp_path / "tr.txt").write_text("c1\n")
    (tmp_path / "va.txt").write_text("c2\n")
    common = ["--data_PC_path", root, "--train_ids", str(tmp_path / "tr.txt"),
              "--val_ids", str(tmp_path / "va.txt"), "--logdir",
              str(tmp_path / "logs"), "--n_point", str(N_POINT),
              "--device", "cpu", "--checkpoint_path", str(ckpt)]
    best = run_brats.main(["--mode", "test", "--results_path",
                           str(tmp_path / "npy"), "--volume_shape", "32",
                           "32", "32"] + common)
    assert best.step == 1 and (tmp_path / "npy" / "c2.npy").exists()
    resumed = run_brats.main(["--mode", "train", "--n_epoch", "1"] + common)
    assert "resumed from step 2" in capsys.readouterr().out
    assert resumed.step == 3


def _write_cts(ct_dir, label_dir, ids=("0001", "0002")):
    rng = np.random.default_rng(5)
    os.makedirs(ct_dir)
    os.makedirs(label_dir)
    shape = (24, 24, 12)
    xx, yy, zz = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
    organ = ((xx - 13) / 4) ** 2 + ((yy - 11) / 3) ** 2 + ((zz - 6) / 3) ** 2 < 1
    for cid in ids:
        ct = 40.0 + 20.0 * rng.standard_normal(shape) + 100.0 * organ
        nifti.save(ct.astype(np.float32),
                   os.path.join(ct_dir, f"PANCREAS_{cid}.nii.gz"))
        nifti.save(organ.astype(np.uint8),
                   os.path.join(label_dir, f"label{cid}.nii.gz"))


def test_run_pancreas_restores_the_export(tmp_path):
    """A Pancreas-config state (the reference's init, one Adam update),
    exported: its latest snapshot loads with the reference's moments
    (what ``run_pancreas --mode train`` resumes from; ``run_brats``'s
    test drives that resume) and ``run_pancreas --mode test`` restores
    its best one."""
    cfg = ref_config.pancreas_pointseg_config(num_points=512)
    trainer = RefPointTrainer(cfg)
    state = advance(trainer, trainer.init_state(seed=3), 1, seed=3)
    state = jax.tree_util.tree_map(np.asarray, state)
    ckpt = RefCheckpointer(str(tmp_path / "orbax"))
    ckpt.save(state, 1, metric=0.25)
    ckpt.close()
    out = tmp_path / "fold1"
    export_jax_checkpoint.export(str(tmp_path / "orbax"), str(out), state,
                                 "pointseg")
    port_cfg = port_config.pancreas_pointseg_config(num_points=512)
    restored = PointSegTrainer(port_cfg, device="cpu").init_state()
    BestMetricCheckpointer(str(out)).restore_latest(restored)
    assert_point_state(restored, state)

    _write_cts(str(tmp_path / "ct"), str(tmp_path / "label"))
    data_prepare_pancreas.main([
        "--data_3D_path", str(tmp_path / "ct"), "--label_path",
        str(tmp_path / "label"), "--outPC_path", str(tmp_path / "pc"),
        "--n_point", "512", "--seed", "3"])
    best = run_pancreas.main([
        "--mode", "test", "--data_3D_path", str(tmp_path / "ct"),
        "--results_path", str(tmp_path / "npy"), "--data_PC_path",
        str(tmp_path / "pc"), "--fold", "1", "--n_point", "512", "--device",
        "cpu", "--logdir", str(tmp_path / "logs"), "--checkpoint_path",
        str(out)])
    assert best.step == 1 and os.listdir(tmp_path / "npy")
    for name, t in restored.model.state_dict().items():
        assert torch.equal(best.model.state_dict()[name], t), name


# ------------------------------------------------------------ refusals


def test_an_orbax_directory_names_the_exporter(point_run, tmp_path):
    orbax = str(point_run["root"] / "orbax")
    cfg = port_config.brats_pointseg_config(num_points=N_POINT)
    with pytest.raises(SystemExit, match="export_jax_checkpoint.py"):
        segment._restore(orbax, PointSegTrainer(cfg, device="cpu"))
    state = PointSegTrainer(cfg, device="cpu").init_state()
    with pytest.raises(SystemExit, match="export_jax_checkpoint.py"):
        BestMetricCheckpointer(orbax).restore_latest(state)
    root = make_point_tree(str(tmp_path / "pc"), ["c1"],
                           rng=np.random.default_rng(0))
    with pytest.raises(SystemExit, match="export_jax_checkpoint.py"):
        run_brats.main(["--mode", "test", "--data_PC_path", root,
                        "--checkpoint_path", orbax, "--device", "cpu",
                        "--n_point", str(N_POINT), "--logdir",
                        str(tmp_path / "logs")])


def test_two_snapshots_of_one_step_raise(point_run, tmp_path):
    cfg = port_config.brats_pointseg_config(num_points=N_POINT)
    state = PointSegTrainer(cfg, device="cpu").init_state()
    BestMetricCheckpointer(str(tmp_path)).save(state, 2)
    os.link(point_run["root"] / "export" / "2.npz", tmp_path / "2.npz")
    with pytest.raises(ValueError, match="two snapshots of step 2"):
        BestMetricCheckpointer(str(tmp_path)).restore_latest(state)


def test_saving_over_an_exported_step_replaces_it(point_run, tmp_path):
    """Training on in an exported directory writes ``.pt``; a step saved
    again replaces its ``.npz``."""
    os.link(point_run["root"] / "export" / "2.npz", tmp_path / "2.npz")
    cfg = port_config.brats_pointseg_config(num_points=N_POINT)
    state = PointSegTrainer(cfg, device="cpu").init_state()
    ck = BestMetricCheckpointer(str(tmp_path))
    ck.restore_latest(state)
    ck.save(state, 2, metric=1.0)
    assert sorted(os.listdir(tmp_path)) == ["2.pt", "best", "best.json"]
    fresh = PointSegTrainer(cfg, device="cpu").init_state()
    ck.restore_best(fresh)
    assert_point_state(fresh, point_run["states"][2])


# ------------------------------------------------------------ the fixture


def test_committed_fixture_matches_the_recorded_jax_logits():
    """What JAX wrote, exported and committed: the port's logits against
    the recorded JAX logits, its state against the export's."""
    meta = json.loads((FIXTURE / "meta.json").read_text())
    pcfg, scfg = fixture_configs(meta)
    with np.load(FIXTURE / "inputs.npz") as z:
        inputs = {k: z[k] for k in z.files}
    trainer = PointSegTrainer(pcfg, device="cpu")
    state = trainer.init_state()
    ck = BestMetricCheckpointer(str(FIXTURE / "pointseg"))
    assert ck.restore_latest(state) is state and state.step == meta["steps"]
    feats = inputs["point_feats"]                 # xyz, then 4 modalities
    got = port_point_logits(state.model, pcfg,
                            np.ascontiguousarray(feats[..., :3]), feats)
    assert_point_logits(got, inputs["point_logits"])
    sal = SaliencyTrainer(scfg, device="cpu", attention=False).init_state()
    BestMetricCheckpointer(str(FIXTURE / "saliency")).restore_best(sal)
    assert sal.step == meta["steps"]
    got = port_saliency_logits(sal.model, inputs["saliency_x"])
    np.testing.assert_allclose(got, inputs["saliency_logits"], **SALIENCY_BAR)
    size = sum(f.stat().st_size for f in FIXTURE.rglob("*") if f.is_file())
    assert size <= 512 * 1024, size


