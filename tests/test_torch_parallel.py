"""The port's multi-device layer (pointunet_tpu_torch/parallel/, the mesh
branches of PointSegTrainer and FusedPointUnet.segment_batch_device) on
4 gloo ranks on the CPU, against the single-process port and the
reference (tests/test_parallel.py runs the reference's on 8 virtual
devices).

The ranks are spawned processes running tests/torch_dist_workers.py
(jax-free); each spawn is a module fixture that several tests read.

Bars of the train steps (f32, a 2-level net at 4,096 points, a global
batch of 4; the point-sharded pyramid from 1,024 rows; on dp2sp2 each
point rank runs its slab of every level's rows, as
tests/test_torch_point_sharded.py checks further; 2 steps without
dropout and 2 with it, whose mask is drawn for the global batch):

* the loss of each of 2 steps within rtol 1e-4 of the single process's
  (tests/test_parallel.py's bar), and the first step's (no dropout)
  within 1e-4 relative of the reference's single-device loss on the same
  weights: the f32 bar of the parity tests whose two sides build their
  own pyramids (tests/test_torch_pancreas.py; measured 3.4e-5, where 3 of
  the 16,384 level-0 neighbour rows differ in distance ties: the
  reference's brute force ranks by the matmul form of d^2);
* the first step's gradient, summed over the mesh, within 5e-3 x its
  tensor's max |g| of the single process's (measured: 1.5e-3 for dp4,
  1.9e-4 for the activation-sharded dp2sp2; merely
  permuting the batch's rows in one process moves it by 4.5e-4: f32
  sums in another order, amplified by the batch norms). The Linear
  biases that feed a batch norm have a zero gradient analytically: there
  both sides must hold rounding noise only (< 1e-6 of the largest
  gradient), as in tests/test_torch_train.py;
* parameters and batch-norm statistics bit-equal across the ranks after
  every step; the statistics after the first step within 1e-5 x their
  tensor's max of the single process's;
* the parameters after 2 steps: Adam divides each gradient by its own
  magnitude, so an element whose gradient is rounding noise moves by
  +-lr either way, and the f32 gradients above agree to ~1e-3 of their
  max: elementwise rtol 1e-5 cannot hold for any change of summation
  order. Permuting the batch's rows in one process leaves 581 of 25,684
  elements outside it (by up to 3.4e-4, 3.4 lr); the mesh must leave at
  most 3 times as many (measured 1,146 for dp4, 1,136 for dp2sp2 with
  point replicas; with the activation-sharded dp2sp2: 737 for the
  permuted rows, 908 for dp4, 622 for dp2sp2). The
  gradient bar above is what a wrong reduction would fail (Adam's first
  step is the same for a gradient off by any factor), and so would the
  second step's loss;
* ``evaluate`` on the initial state: the same mean IoU as the single
  process (the confusion matrix summed over the data group).
"""
import copy
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

import torch_dist_workers as workers
from pointunet_tpu.core.config import brats_pointseg_config as jax_cfg
from pointunet_tpu.train.pointseg import PointSegTrainer as JaxTrainer
from pointunet_tpu_torch.convert import convert_train_state
from pointunet_tpu_torch.core.config import (
    brats_pointseg_config,
    pancreas_pointseg_config,
    pancreas_saliency_config,
)
from pointunet_tpu_torch.models.randlanet import init_randlanet
from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet
from pointunet_tpu_torch.parallel import choose_backend, collectives
from pointunet_tpu_torch.pipeline.fused import FusedPointUnet
from pointunet_tpu_torch.train.pointseg import PointSegTrainer

torch.set_num_threads(1)

WORLD = 4
N, BATCH, STEPS = 4096, 4, 2
SHARD_MIN = 1024
NET = dict(num_points=N, num_layers=2, sub_sampling_ratio=(4, 4),
           d_out=(16, 32), use_bfloat16=False)
# the Linear biases that feed a batch norm: fc0's and every SharedMLP's
BIAS_BEFORE_BN = re.compile(r"(^|SharedMLP_\d+\.)Dense_0\.bias$")


@pytest.fixture(scope="module")
def mesh_runs():
    return collectives.spawn(workers.mesh_rank, WORLD, device="cpu")


@pytest.mark.parametrize("name,shape", [
    ("dp4", (4, 1)), ("dp2sp2", (2, 2)), ("sp4", (1, 4)),
])
def test_mesh_shapes_and_groups(mesh_runs, name, shape):
    """Rank r sits at (r // point, r % point); its data group holds the
    ranks of its point index, its point group those of its data index;
    a batch of 8 splits into equal blocks over the data axis."""
    dp, sp = shape
    for rank, run in enumerate(mesh_runs):
        got = run[name]
        d, p = divmod(rank, sp)
        assert got["shape"] == {"data": dp, "point": sp}
        assert got["coords"] == {"data": d, "point": p}
        assert got["members"] == {
            "data": [i * sp + p for i in range(dp)],
            "point": [d * sp + i for i in range(sp)],
        }
        per = 8 // dp
        assert got["rows"] == (d * per, (d + 1) * per)
        assert (got["device"], got["backend"]) == ("cpu", "gloo")


def test_indivisible_batch_and_too_few_ranks_raise(mesh_runs):
    for run in mesh_runs:
        assert run["dp4"]["indivisible"] == "batch 3 not divisible by data axis 4"
        assert run["dp2sp2"]["indivisible"] == "batch 3 not divisible by data axis 2"
        assert run["sp4"]["indivisible"] is None
        assert run["too_large"] == "mesh 4x2 needs 8 ranks, have 4"


def test_collectives(mesh_runs):
    """all_gather_rows of blocks of 1-4 rows; all_reduce_sum and its
    backward (every rank's loss depends on the sum)."""
    want = torch.cat([torch.full((r + 1, 2), r, dtype=torch.int32)
                      for r in range(WORLD)])
    for rank, run in enumerate(mesh_runs):
        assert torch.equal(run["gathered"], want)
        assert run["reduced"] == 30.0           # 1 + 4 + 9 + 16
        assert run["grad"] == 2.0 * (rank + 1) * 10.0


def test_backend_choice():
    """NCCL only for CUDA ranks with a card each; gloo on the CPU and for
    ranks that share a card (this host has none)."""
    assert choose_backend("cpu", 1) == "gloo"
    assert choose_backend("cuda", 4) == "gloo"
    n = torch.cuda.device_count()
    assert choose_backend("cuda", max(n, 1)) == ("nccl" if n else "gloo")


def test_spawn_reports_a_failing_rank():
    with pytest.raises(RuntimeError, match="rank 2 of 3 failed"):
        collectives.spawn(workers.fail_on_rank, 3, 2, device="cpu")


# ------------------------------------------------------------------ #
# training


def _batch():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(0, 1, (BATCH, N, 3)).astype(np.float32)
    feats = np.concatenate(
        [xyz, rng.standard_normal((BATCH, N, 4)).astype(np.float32)], -1)
    d = np.linalg.norm(xyz - 0.5, axis=-1)
    labels = np.select([d < 0.2, d < 0.3, d < 0.4], [3, 2, 1], 0)
    return xyz, feats, labels.astype(np.int64)


def _flat_train_state(state) -> dict:
    """A reference TrainState -> the flat dict convert_train_state takes."""
    flat = {}
    for coll in ("params", "batch_stats"):
        for k, v in traverse_util.flatten_dict(
            getattr(state, coll), sep="/"
        ).items():
            flat[f"{coll}/{k}"] = np.asarray(v)
    adam = state.opt_state[0]
    for which in ("mu", "nu"):
        for k, v in traverse_util.flatten_dict(
            getattr(adam, which), sep="/"
        ).items():
            flat[f"{which}/{k}"] = np.asarray(v)
    flat["count"] = np.asarray(adam.count)
    flat["step"] = np.asarray(state.step)
    return flat


@pytest.fixture(scope="module")
def train_runs():
    """The reference's initial state (converted) and its single-device
    loss of the first step without dropout; the single-process port's
    steps at both configs, and without dropout on the batch's rows
    permuted; the ranks' runs on the dp4 and dp2sp2 meshes."""
    batch = _batch()
    cfgs = {"no_dropout": brats_pointseg_config(dropout_rate=0.0, **NET),
            "dropout": brats_pointseg_config(**NET)}
    ref = JaxTrainer(jax_cfg(dropout_rate=0.0, **NET))
    ref_state = ref.init_state(seed=3)
    xyz, feats, labels = (jnp.asarray(a) for a in batch)
    pyr = ref.pyramid_fn(xyz)
    order = pyr.order
    ref_loss, _ = jax.jit(ref._loss_fn)(
        ref_state.params, ref_state.batch_stats, ref_state.rng, pyr,
        jnp.take_along_axis(feats, order[..., None], 1),
        jnp.take_along_axis(labels, order, 1),
    )
    state_dict = convert_train_state(
        _flat_train_state(ref_state),
        init_randlanet(cfgs["dropout"], torch.Generator()),
    )

    def single(cfg, rows=slice(None)):
        trainer = PointSegTrainer(cfg, device="cpu")
        state = trainer.init_state()
        # a copy: the optimizer takes the moments' tensors as they are,
        # and its steps would update them in place
        state.load_state_dict(copy.deepcopy(state_dict))
        return workers._steps(trainer, state, [a[rows] for a in batch],
                              STEPS)

    trainer = PointSegTrainer(cfgs["dropout"], device="cpu")
    state = trainer.init_state()
    state.load_state_dict(copy.deepcopy(state_dict))
    one = {key: single(cfg) for key, cfg in cfgs.items()}
    one["permuted"] = single(cfgs["no_dropout"], [1, 0, 3, 2])
    one["miou"] = trainer.evaluate(state, [batch], log=lambda *a: None)
    ranks = collectives.spawn(
        workers.train_rank, WORLD, cfgs, state_dict, batch, STEPS, SHARD_MIN,
        device="cpu",
    )
    return {"reference_loss": float(ref_loss), "single": one, "ranks": ranks}


MESH_NAMES = ["dp4", "dp2sp2"]


@pytest.mark.parametrize("name", MESH_NAMES)
def test_train_loss_matches_single_process_and_reference(train_runs, name):
    one = train_runs["single"]
    for run in train_runs["ranks"]:
        for key in ("no_dropout", "dropout"):
            for got, want in zip(run[name][key], one[key]):
                np.testing.assert_allclose(got["loss"], want["loss"],
                                           rtol=1e-4)
        np.testing.assert_allclose(run[name]["no_dropout"][0]["loss"],
                                   train_runs["reference_loss"], rtol=1e-4)
    # the point axis shares the pyramids: the evaluation and each config's
    # steps built theirs through build_pyramid_sharded
    assert train_runs["ranks"][0][name]["sharded_pyramids"] == (
        0 if name == "dp4" else 1 + 2 * STEPS)


@pytest.mark.parametrize("name", MESH_NAMES)
def test_train_gradients_match_single_process(train_runs, name):
    want = train_runs["single"]["no_dropout"][0]["grads"]
    top = max(float(g.abs().max()) for g in want.values())
    for run in train_runs["ranks"]:
        got = run[name]["no_dropout"][0]["grads"]
        assert set(got) == set(want)
        for key, w in want.items():
            if BIAS_BEFORE_BN.search(key):
                assert float(w.abs().max()) < 1e-6 * top, key
                assert float(got[key].abs().max()) < 1e-6 * top, key
                continue
            bound = 5e-3 * float(w.abs().max())
            err = float((got[key] - w).abs().max())
            assert err <= bound, (key, err, bound)


@pytest.mark.parametrize("name", MESH_NAMES)
def test_train_state_equal_across_ranks(train_runs, name):
    """Parameters and batch-norm statistics bit-equal on every rank after
    every step of both configs; the statistics of the first step as the
    single process's."""
    for key in ("no_dropout", "dropout"):
        ranks = [run[name][key] for run in train_runs["ranks"]]
        for i in range(STEPS):
            for what in ("params", "buffers"):
                for leaf, t in ranks[0][i][what].items():
                    for other in ranks[1:]:
                        assert torch.equal(other[i][what][leaf], t), (
                            key, i, leaf)
    want = train_runs["single"]["no_dropout"][0]["buffers"]
    got = train_runs["ranks"][0][name]["no_dropout"][0]["buffers"]
    for leaf, w in want.items():
        if w.is_floating_point():
            err = float((got[leaf] - w).abs().max())
            assert err <= 1e-5 * float(w.abs().max()), (leaf, err)


def test_update_sums_the_meshs_gradients(train_runs):
    """On dp2sp2, rank r holding the gradient r + 1: every rank's update
    takes the sum over the whole mesh, 1 + 2 + 3 + 4 = 10 (each rank's
    own is the gradient of its clouds' slab of the loss)."""
    for run in train_runs["ranks"]:
        assert run["synced_grads"] == [10.0]


def _outside(got: dict, want: dict) -> int:
    """Parameter elements of ``got`` beyond rtol 1e-5 of ``want``'s."""
    return sum(int(((got[k] - w).abs() > 1e-5 * w.abs()).sum())
               for k, w in want.items())


@pytest.mark.parametrize("name", MESH_NAMES)
def test_train_parameters_match_single_process(train_runs, name):
    """After 2 steps the mesh's parameters stray from the single
    process's no more than 3 times as far as the single process's own run
    on the batch's rows permuted (see the module docstring)."""
    one = train_runs["single"]
    want = one["no_dropout"][-1]["params"]
    baseline = _outside(one["permuted"][-1]["params"], want)
    got = train_runs["ranks"][0][name]["no_dropout"][-1]["params"]
    assert 0 < _outside(got, want) <= 3 * baseline, (
        _outside(got, want), baseline)


@pytest.mark.parametrize("name", MESH_NAMES)
def test_evaluate_matches_single_process(train_runs, name):
    for run in train_runs["ranks"]:
        assert run[name]["miou"] == train_runs["single"]["miou"]


# ------------------------------------------------------------------ #
# the data-parallel fused batch

VOLUME = (48, 48, 32)          # (X, Y, Z)
N_FUSED = 4096


def _ct(flip: bool) -> np.ndarray:
    """A Pancreas-like CT channel: a body oval with noise and an organ
    blob (tests/test_torch_pancreas_fused.py's)."""
    rng = np.random.default_rng(0)
    xx, yy, zz = np.meshgrid(*(np.arange(s) for s in VOLUME), indexing="ij")
    body = (((xx - 24) / 22) ** 2 + ((yy - 24) / 19) ** 2) < 1
    organ = ((xx - 27) ** 2 + (yy - 21) ** 2 + (zz - 16) ** 2) < 25
    vol = 0.41 + 0.06 * rng.standard_normal(VOLUME) + 0.3 * organ
    vol = (np.clip(vol, 0, 1) * body).astype(np.float32)
    return vol[::-1].copy() if flip else vol


def test_segment_batch_device_on_a_mesh():
    """Two volumes on the dp2sp2 mesh (a Pancreas config with a
    saliency net of base width 4): each data rank segments its own, the
    point ranks the same one, and every rank returns both volumes'
    labels, bit-equal to the one-card loop."""
    scfg = pancreas_saliency_config(sa_gate_stride=2, base_filter=4)
    pcfg = pancreas_pointseg_config(num_points=N_FUSED)
    torch.manual_seed(0)
    sal = SaliencyUNet(scfg).eval()
    pseg = init_randlanet(pcfg, torch.Generator().manual_seed(0))
    pipe = FusedPointUnet(sal, pseg, scfg, pcfg, threshold=0.5,
                          volume_shape=VOLUME, device="cpu")
    mods = torch.from_numpy(np.stack([_ct(False), _ct(True)])[:, None])
    seeds = [4, 5]
    want = pipe.segment_batch_device(mods, seeds)
    ranks = collectives.spawn(
        workers.fused_rank, WORLD, sal.state_dict(), pseg.state_dict(),
        (scfg, pcfg), mods, seeds, VOLUME, device="cpu",
    )
    for run in ranks:
        assert run["labels"].dtype == torch.uint8
        assert torch.equal(run["labels"], want)
    # each data rank segmented one volume
    assert [run["segmented"] for run in ranks] == [1, 1, 1, 1]
    assert not torch.equal(want[0], want[1])
