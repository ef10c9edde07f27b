"""The activation-sharded point net (``RandLANet(point_group=)``, the
point axis of ``PointSegTrainer``'s mesh; the reference's ``_pshard``) on
4 gloo ranks on the CPU, against the single-process port and the
reference's loss.

One module-scoped spawn (tests/torch_dist_workers.py:point_sharded_rank)
runs every case on the sp4 (data 1, point 4) and dp2sp2 meshes, at
tests/test_torch_parallel.py's net (f32, 2 levels, 4,096 points, ratios
(4, 4); the sharded pyramid from 1,024 rows) on a global batch of its
first 2 clouds. Rank p computes slab p of every level's rows and makes
each gather's source table whole with ``all_gather_rows_grad``. Bars:

* the autograd all-gather: its forward bit-equal to the concatenated
  slabs on every rank, its backward within 1e-12 x max|g| of a
  one-process gather-then-sum in f64 (measured 9.1e-17);
* the logits of the sharded forward (train mode: batch norms over the
  mesh; eval mode), gathered, within 1e-5 x max|logits| of the single
  process's: f32 sums of the statistics in another order (measured
  2.1e-6 and 1.2e-6);
* the first step's gradient, summed over the mesh, within 5e-3 x its
  tensor's max|g| of the single process's (tests/test_torch_parallel.py's
  bar and its treatment of the Linear biases that feed a batch norm),
  each step's loss within rtol 1e-4 of the single process's, and the
  first loss within rtol 1e-4 of the reference's single-device loss
  (measured: 7.2e-6, 7.2e-8 and 1.0e-5);
* the same with the grid threshold lowered to 512 rows and ``MIN_ROWS``
  to 0 in the ranks and the single process (``low_gate``), so that every
  gather's backward runs the sorted scatter's plan on slabs of queries:
  6 scatters a cloud a step, of the slab's rows. The first loss is then
  held to the single process's under the same gate, not to the
  reference's: the lowered threshold moves levels 0 and 1 to the
  cell-window search, which the reference runs on the CPU by another
  algorithm (its XLA fallback, not the Pallas kernel that kernel 1
  follows), and the two pyramids' losses differ by 2.3e-4 relative
  (1.0e-5 at the default threshold, where both search by brute force);
* the dropout keep-mask of each rank's slab equal to the single
  process's mask at those rows;
* parameters and batch-norm statistics bit-equal across the ranks after
  each of 2 steps.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_parallel as tp
import torch_dist_workers as workers
from pointunet_tpu.core.config import brats_pointseg_config as jax_cfg
from pointunet_tpu.train.pointseg import PointSegTrainer as JaxTrainer
from pointunet_tpu_torch.convert import convert_train_state
from pointunet_tpu_torch.core.config import brats_pointseg_config
from pointunet_tpu_torch.models.randlanet import init_randlanet
from pointunet_tpu_torch.ops.pyramid import take_level0
from pointunet_tpu_torch.ops.pyramid_sharded import slab_sizes
from pointunet_tpu_torch.parallel import collectives
from pointunet_tpu_torch.train.pointseg import PointSegTrainer

torch.set_num_threads(1)

WORLD, BATCH, STEPS = 4, 2, 2
LOW_THRESHOLD = 512
K = 16
MESHES = {"sp4": (1, 4), "dp2sp2": (2, 2)}


def _reference_loss(batch) -> tuple:
    """The reference's initial state (seed 3) and its single-device loss
    of the first step without dropout on ``batch``."""
    ref = JaxTrainer(jax_cfg(dropout_rate=0.0, **tp.NET))
    ref_state = ref.init_state(seed=3)
    xyz, feats, labels = (jnp.asarray(a) for a in batch)
    pyr = ref.pyramid_fn(xyz)
    order = pyr.order
    loss, _ = jax.jit(ref._loss_fn)(
        ref_state.params, ref_state.batch_stats, ref_state.rng, pyr,
        jnp.take_along_axis(feats, order[..., None], 1),
        jnp.take_along_axis(labels, order, 1),
    )
    return ref_state, float(loss)


@pytest.fixture(scope="module")
def runs():
    batch = [a[:BATCH] for a in tp._batch()]
    cfgs = {"no_dropout": brats_pointseg_config(dropout_rate=0.0, **tp.NET),
            "dropout": brats_pointseg_config(**tp.NET)}
    ref_state, ref_loss = _reference_loss(batch)
    state_dict = convert_train_state(
        tp._flat_train_state(ref_state),
        init_randlanet(cfgs["dropout"], torch.Generator()),
    )

    def single():
        trainer = PointSegTrainer(cfgs["no_dropout"], device="cpu")
        state = trainer.init_state()
        state.load_state_dict(copy.deepcopy(state_dict))
        return trainer, state

    trainer, state = single()
    xyz, feats, _ = (torch.as_tensor(a) for a in batch)
    pyr = trainer.pyramid_fn(xyz)
    f0 = take_level0(pyr, feats.float())
    with torch.no_grad():
        logits = {mode: getattr(state.model, mode)()(f0, pyr)
                  for mode in ("train", "eval")}
    one = {"logits": logits,
           "steps": workers._steps(*single(), batch, STEPS)}
    with workers.low_gate(LOW_THRESHOLD) as calls:
        one["low_steps"] = workers._steps(*single(), batch, STEPS)
    one["low_scatters"] = list(calls)
    one["keep"] = state.model._dropout_keep(
        (BATCH, tp.N, 32), "cpu", cfgs["dropout"].dropout_rate,
        torch.Generator().manual_seed(7), tp.N)
    ranks = collectives.spawn(
        workers.point_sharded_rank, WORLD, cfgs, state_dict, batch, STEPS,
        tp.SHARD_MIN, LOW_THRESHOLD, device="cpu",
    )
    return {"reference_loss": ref_loss, "single": one, "ranks": ranks}


def test_all_gather_rows_grad(runs):
    """Forward: every rank gets the slabs concatenated, bit for bit.
    Backward: the gradient of sum_r sum(whole * w_r) is sum_r w_r, of
    which rank j keeps its slab's rows."""
    cases = [run["gather"] for run in runs["ranks"]]
    sizes = cases[0]["sizes"]
    table = torch.cat([c["t"] for c in cases])
    want = sum(c["w"] for c in cases)
    bound = 1e-12 * float(want.abs().max())
    for j, c in enumerate(cases):
        assert c["whole"].dtype == torch.float64
        assert torch.equal(c["whole"], table)
        lo = sum(sizes[:j])
        err = float((c["grad"] - want[lo:lo + sizes[j]]).abs().max())
        assert err <= bound, (j, err)


@pytest.mark.parametrize("name", list(MESHES))
def test_slabs_cover_every_row(runs, name):
    """Rank (d, p) holds the data block d of the batch and slab p of the
    4,096 level-0 rows."""
    dp, sp = MESHES[name]
    sizes = slab_sizes(tp.N, sp)
    for rank, run in enumerate(runs["ranks"]):
        d, p = divmod(rank, sp)
        per = BATCH // dp
        assert run[name]["rows"] == (d * per, (d + 1) * per)
        lo = sum(sizes[:p])
        assert run[name]["slab"] == (lo, lo + sizes[p])


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_logits_match_single_process(runs, name, mode):
    want = runs["single"]["logits"][mode]
    scale = float(want.abs().max())
    for run in runs["ranks"]:
        lo, hi = run[name]["rows"]
        got = run[name]["logits"][mode]
        assert got.shape == want[lo:hi].shape
        err = float((got - want[lo:hi]).abs().max())
        assert err <= 1e-5 * scale, (err, scale)


def _check_steps(runs, name, key):
    """Gradients of the first step, every step's loss, the first loss
    against the reference's at the default gate (the bars of the module
    docstring)."""
    one = runs["single"][key]
    want = one[0]["grads"]
    top = max(float(g.abs().max()) for g in want.values())
    for run in runs["ranks"]:
        steps = run[name][key]
        for got, w in zip(steps, one):
            np.testing.assert_allclose(got["loss"], w["loss"], rtol=1e-4)
        if key == "steps":
            np.testing.assert_allclose(steps[0]["loss"],
                                       runs["reference_loss"], rtol=1e-4)
        grads = steps[0]["grads"]
        assert set(grads) == set(want)
        for leaf, w in want.items():
            if tp.BIAS_BEFORE_BN.search(leaf):
                assert float(w.abs().max()) < 1e-6 * top, leaf
                assert float(grads[leaf].abs().max()) < 1e-6 * top, leaf
                continue
            err = float((grads[leaf] - w).abs().max())
            assert err <= 5e-3 * float(w.abs().max()), (leaf, err)


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_steps_match_single_process_and_reference(runs, name):
    _check_steps(runs, name, "steps")


@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_steps_on_the_sorted_scatter_plan(runs, name):
    """Under ``low_gate`` the backward of each of a cloud's 6 sorted
    gathers (levels 0 and 1: two LFA gathers and the pool) runs the
    plan, on the slab's query rows against the whole level."""
    _check_steps(runs, name, "low_steps")
    dp, sp = MESHES[name]
    n = [tp.N, tp.N // 4, tp.N // 16]

    def plan(m, clouds):
        """(ct rows, support rows) of each call: queries m[l] a level."""
        one = ([(m[0] * K, n[0])] * 2 + [(m[1] * K, n[0])]
               + [(m[1] * K, n[1])] * 2 + [(m[2] * K, n[1])])
        return sorted(one * clouds * STEPS)

    assert sorted(runs["single"]["low_scatters"]) == plan(n, BATCH)
    for rank, run in enumerate(runs["ranks"]):
        m = [slab_sizes(x, sp)[rank % sp] for x in n]
        assert sorted(run[name]["low_scatters"]) == plan(m, BATCH // dp)


@pytest.mark.parametrize("name", list(MESHES))
def test_dropout_mask_matches_single_process(runs, name):
    want = runs["single"]["keep"]
    assert want.dtype == torch.bool and 0 < float(want.float().mean()) < 1
    for run in runs["ranks"]:
        lo, hi = run[name]["rows"]
        s0, s1 = run[name]["slab"]
        assert torch.equal(run[name]["keep"], want[lo:hi, s0:s1])


@pytest.mark.parametrize("key", ["steps", "low_steps"])
@pytest.mark.parametrize("name", list(MESHES))
def test_sharded_state_equal_across_ranks(runs, name, key):
    ranks = [run[name][key] for run in runs["ranks"]]
    for i in range(STEPS):
        for what in ("params", "buffers"):
            for leaf, t in ranks[0][i][what].items():
                for other in ranks[1:]:
                    assert torch.equal(other[i][what][leaf], t), (i, leaf)
