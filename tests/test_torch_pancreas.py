"""The port's Pancreas point path against the reference's, on the CPU at
small sizes, inputs made with numpy from a seed: the dataset
(data/datasets.py:PancreasPointDataset), the prep CLI
(cli/data_prepare_pancreas.py), the trainer at the Pancreas config, the
CLI (cli/run_pancreas.py) and ``serve --dataset pancreas``.

Bars: the host side (prep, dataset) is bit-equal, since both use numpy's
generator; ``eval_step``'s probabilities at ``pancreas_pointseg_config``
(f32, the reference's weights converted, the reference's pyramid fed in)
within the f32 bar of the other parity tests, 1e-4; the scatter of
probabilities into the CT's grid from uint16 origins bit for bit.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointunet_tpu.cli import data_prepare_pancreas as ref_prep
from pointunet_tpu.core.config import pancreas_pointseg_config as jax_cfg
from pointunet_tpu.data.datasets import PancreasPointDataset as JaxDataset
from pointunet_tpu.ops.scatter import scatter_probs_to_volume as jax_scatter
from pointunet_tpu.train.pointseg import PointSegTrainer as JaxTrainer
from pointunet_tpu_torch.cli import data_prepare_pancreas, run_pancreas
from pointunet_tpu_torch.core.config import pancreas_pointseg_config
from pointunet_tpu_torch.data import nifti
from pointunet_tpu_torch.data.datasets import PancreasPointDataset
from pointunet_tpu_torch.data.ply import read_ply
from pointunet_tpu_torch.ops.pyramid import Pyramid
from pointunet_tpu_torch.ops.scatter import scatter_probs_to_volume
from pointunet_tpu_torch.train.pointseg import PointSegTrainer
from test_torch_train import _flat_train_state, _port_state
from torch_parity import named_to_flax_flat, to_torch, voxel_block

torch.set_num_threads(1)

SHAPE = (24, 24, 16)                   # (X, Y, Z) of the synthetic CTs
IDS = ("0001", "0002", "0003")
N = 512


def _write_cts(ct_dir, label_dir, ids=IDS, shapes=None, rng=None):
    """``PANCREAS_<ID>.nii.gz`` CTs in HU (a body oval of soft tissue with
    seeded noise, air outside, a raised organ blob) and their
    ``label<ID>.nii.gz``."""
    rng = rng or np.random.default_rng(0)
    os.makedirs(ct_dir, exist_ok=True)
    os.makedirs(label_dir, exist_ok=True)
    for i, cid in enumerate(ids):
        shape = shapes[i] if shapes else SHAPE
        xx, yy, zz = np.meshgrid(*(np.arange(s) for s in shape), indexing="ij")
        body = (((xx - shape[0] / 2) / (0.46 * shape[0])) ** 2
                + ((yy - shape[1] / 2) / (0.4 * shape[1])) ** 2) < 1.0
        organ = (((xx - shape[0] * 0.55) / 4) ** 2 + ((yy - shape[1] * 0.45) / 3)
                 ** 2 + ((zz - shape[2] / 2) / 3) ** 2) < 1.0
        ct = np.where(body, 40.0 + 20.0 * rng.standard_normal(shape), -1000.0)
        ct += 100.0 * organ
        nifti.save(ct.astype(np.float32),
                   os.path.join(ct_dir, f"PANCREAS_{cid}.nii.gz"))
        nifti.save(organ.astype(np.uint8),
                   os.path.join(label_dir, f"label{cid}.nii.gz"))


@pytest.fixture(scope="module")
def cts(tmp_path_factory):
    root = tmp_path_factory.mktemp("pancreas")
    _write_cts(str(root / "ct"), str(root / "label"))
    return root


@pytest.fixture(scope="module")
def tree(cts):
    """The port's prepared tree of the three CTs."""
    data_prepare_pancreas.main([
        "--data_3D_path", str(cts / "ct"), "--label_path", str(cts / "label"),
        "--outPC_path", str(cts / "pc"), "--n_point", str(N), "--seed", "3",
    ])
    return cts / "pc"


def _files(root):
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            out[os.path.relpath(path, root)] = (
                read_ply(path) if f.endswith(".ply") else np.load(path))
    return out


def test_prep_equals_reference(cts, tree):
    ref_prep.main([
        "--data_3D_path", str(cts / "ct"), "--label_path", str(cts / "label"),
        "--outPC_path", str(cts / "ref_pc"), "--n_point", str(N),
        "--seed", "3",
    ])
    got, want = _files(tree), _files(cts / "ref_pc")
    assert sorted(got) == sorted(want)
    assert len(got) == 2 * 8 * len(IDS)                # 8 loops a case
    for name, w in want.items():
        assert got[name].dtype == w.dtype, name
        np.testing.assert_array_equal(got[name], w, err_msg=name)
    origin = got["input0.01/0001_xyz_origin_loop_0.npy"]
    assert origin.dtype == np.uint16 and origin.shape == (N, 3)
    cloud = got["original_ply/0001_loop_0.ply"]
    assert cloud.dtype.names == ("x", "y", "z", "value", "class")
    assert cloud["class"].sum() > 0                    # the organ, all of it


@pytest.mark.parametrize("fold", [1, 3])
def test_dataset_equals_reference(tree, fold):
    cfg = pancreas_pointseg_config(num_points=N)
    ref = JaxDataset(str(tree), fold, jax_cfg(num_points=N))
    port = PancreasPointDataset(str(tree), fold, cfg)
    assert port.files == ref.files
    val = [os.path.basename(p)[:4] for p in port.files["validation"]]
    assert set(val) == {f"{fold:04d}"} and len(val) == 8
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
    name, xyz, feats, labels, origin = next(port.test_iter())
    assert xyz.shape == (1, N, 3) and feats.shape == (1, N, 4)
    assert origin.shape == (N, 3) and origin.dtype == np.uint16


def test_eval_step_equals_reference():
    """At ``pancreas_pointseg_config`` (1 CT channel, 2 classes, full
    widths, f32), with the reference's weights carried over by
    ``convert_train_state`` and its pyramid fed in. Random weights put a
    large offset on one class's logit everywhere; the head's bias is
    centred on this cloud (on both sides) so that the probabilities
    compared are not all 1."""
    from flax import traverse_util

    rng = np.random.default_rng(1)
    xyz = voxel_block((16, 16, 16), rng)
    n = len(xyz)
    feats = np.concatenate(
        [xyz, rng.uniform(size=(n, 1)).astype(np.float32)], -1)[None]
    labels = (np.linalg.norm(xyz - 0.5, axis=-1) < 0.2).astype(np.int32)[None]
    ref_trainer = JaxTrainer(jax_cfg(num_points=n, use_bfloat16=False))
    ref_state = ref_trainer.init_state(seed=2)
    jpyr = ref_trainer.pyramid_fn(jnp.asarray(xyz[None]))

    cfg = pancreas_pointseg_config(num_points=n, use_bfloat16=False)
    assert cfg.num_features == 1 and cfg.num_classes == 2
    trainer, state = _port_state(_flat_train_state(ref_state), cfg)
    pyr = Pyramid(*to_torch(jpyr))
    trainer.pyramid_fn = lambda _: pyr
    order = pyr.order[0].long()
    with torch.no_grad():
        logits = state.model.eval()(torch.from_numpy(feats)[:, order], pyr)
        state.model.head.bias -= logits[0].mean(0)
    params = {k[len("params/"):]: jnp.asarray(v)
              for k, v in named_to_flax_flat(state.model.state_dict()).items()
              if k.startswith("params/")}
    ref_state = ref_state._replace(
        params=traverse_util.unflatten_dict(params, sep="/"))
    want = np.asarray(ref_trainer.eval_step(ref_state, xyz[None], feats))
    got = trainer.eval_step(state, xyz[None], feats, labels).numpy()
    assert got.shape == want.shape == (1, n, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    # both classes win somewhere: the probabilities are not a constant
    assert set(np.unique(want.argmax(-1))) == {0, 1}


def test_scatter_from_uint16_origin_equals_reference():
    rng = np.random.default_rng(2)
    shape = (16, 24, 24)                                # (Z, Y, X)
    flat = rng.choice(np.prod(shape), 700, replace=False)
    z, y, x = np.unravel_index(flat, shape)
    origin = np.stack([x, y, z], -1).astype(np.uint16)
    probs = rng.dirichlet(np.ones(2), 700).astype(np.float32)
    want = np.asarray(jax_scatter(jnp.asarray(probs),
                                  jnp.asarray(origin.astype(np.int32)), shape))
    got = scatter_probs_to_volume(
        torch.from_numpy(probs), torch.from_numpy(origin.astype(np.int64)),
        shape).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_run_pancreas_train_then_test_on_cpu(tmp_path, cts, tree):
    logdir = tmp_path / "logs"
    results = tmp_path / "res"
    common = ["--data_PC_path", str(tree), "--logdir", str(logdir),
              "--n_point", str(N), "--fold", "3", "--device", "cpu"]
    state = run_pancreas.main(["--mode", "train", "--n_epoch", "1"] + common)
    assert state.step == 16                     # 8 loops of 0001 and 0002
    assert (logdir / "fold3" / "best.json").exists()
    assert (logdir / "scalars.jsonl").exists()
    run_pancreas.main(["--mode", "test", "--results_path", str(results),
                       "--data_3D_path", str(cts / "ct")] + common)
    assert sorted(os.listdir(results)) == [f"0003_loop_{k}.npy"
                                          for k in range(8)]
    vol = np.load(results / "0003_loop_0.npy")
    x, y, z = SHAPE
    assert vol.shape == (z, y, x, 2) and vol.dtype == np.float32
    filled = vol.sum(-1)
    assert (filled > 0).sum() == N              # the loop's voxels, unique
    np.testing.assert_allclose(filled[filled > 0], 1.0, rtol=1e-5)
    summary = (logdir / "train_summary.txt").read_text()
    assert "0003_loop_7: point dice" in summary and "mean point dice" in summary
    with pytest.raises(SystemExit, match="--data_3D_path"):
        run_pancreas.main(["--mode", "test"] + common)


def test_run_pancreas_defaults_to_the_card(tree, tmp_path, monkeypatch):
    """Without ``--device`` the trainer is built for cuda: on a host with
    no card it fails rather than training on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        run_pancreas.main(["--mode", "train", "--n_epoch", "1",
                           "--data_PC_path", str(tree), "--logdir",
                           str(tmp_path / "logs"), "--n_point", str(N)])


# ------------------------------------------------------------------ serve


def test_serve_pancreas_two_shapes(tmp_path):
    """Two CTs of different Z: both served, one pipe a shape, labels in
    {0, 1}; a half-written CT fails on three polls and is then skipped."""
    from pointunet_tpu_torch.cli import serve

    inbox, outbox = tmp_path / "in", tmp_path / "out"
    _write_cts(str(inbox), str(tmp_path / "labels"), ids=("0001", "0002"),
               shapes=[(32, 32, 16), (32, 32, 32)])
    whole = (inbox / "PANCREAS_0001.nii.gz").read_bytes()
    (inbox / "PANCREAS_0003.nii.gz").write_bytes(whole[: len(whole) // 3])
    server = serve.main([
        "--inbox", str(inbox), "--outbox", str(outbox), "--once",
        "--dataset", "pancreas", "--device", "cpu", "--n_point", "2048",
    ])
    assert server.served == 2
    assert sorted(server.pipes) == [(32, 32, 16), (32, 32, 32)]
    assert server.failures == {"PANCREAS_0003": 1}
    for cid, z in (("0001", 16), ("0002", 32)):
        labels = nifti.load(str(outbox / f"PANCREAS_{cid}.nii.gz")).data
        assert labels.shape == (32, 32, z) and labels.dtype == np.uint8
        assert set(np.unique(labels)) <= {0, 1}
        assert int((labels > 0).sum()) <= 2048
    for _ in range(3):
        server.drain()
    assert server.failures == {"PANCREAS_0003": 3} and server.served == 2
    assert not (outbox / "PANCREAS_0003.json").exists()


def test_serve_pancreas_head_biased_to_the_organ(tmp_path):
    """``--pointseg_checkpoint`` at the Pancreas config: a head biased to
    class 1 labels every sampled voxel 1, written as 1 (no BraTS remap)."""
    from pointunet_tpu_torch.cli import serve
    from pointunet_tpu_torch.core.checkpoint import BestMetricCheckpointer

    n = 2048
    state = PointSegTrainer(pancreas_pointseg_config(num_points=n),
                            device="cpu").init_state(seed=5)
    with torch.no_grad():
        state.model.head.bias[1] += 1e4
    BestMetricCheckpointer(str(tmp_path / "ckpt")).save(state, 1, metric=0.5)
    inbox, outbox = tmp_path / "in", tmp_path / "out"
    _write_cts(str(inbox), str(tmp_path / "labels"), ids=("0001",),
               shapes=[(32, 32, 16)])
    server = serve.main([
        "--inbox", str(inbox), "--outbox", str(outbox), "--once",
        "--dataset", "pancreas", "--device", "cpu", "--n_point", str(n),
        "--pointseg_checkpoint", str(tmp_path / "ckpt"),
    ])
    assert server.served == 1
    labels = nifti.load(str(outbox / "PANCREAS_0001.nii.gz")).data
    assert set(np.unique(labels)) == {0, 1} and (labels == 1).sum() == n
