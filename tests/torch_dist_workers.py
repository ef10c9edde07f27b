"""Rank functions of the port's multi-device tests
(tests/test_torch_parallel.py, tests/test_torch_pyramid_sharded.py,
tests/test_torch_point_sharded.py).

``parallel.collectives.spawn`` starts each rank in a fresh process that
imports this module by name, so it imports torch and the port only: no
jax, and not the conftest. Each function runs on every rank of a gloo
group on the CPU and returns what the test compares.
"""
from __future__ import annotations

import contextlib
import copy

import torch
import torch.distributed as dist

from pointunet_tpu_torch.core.config import MeshConfig
from pointunet_tpu_torch.parallel import collectives
from pointunet_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    POINT_AXIS,
    batch_sharding,
    make_mesh,
)

MESHES = {"dp4": MeshConfig(4, 1), "dp2sp2": MeshConfig(2, 2),
          "sp4": MeshConfig(1, 4)}


def _members(group) -> list:
    """The global ranks of ``group``, in group-rank order."""
    me = torch.tensor([dist.get_rank()])
    size = dist.get_world_size(group)
    return [int(r) for r in collectives.all_gather_rows(me, [1] * size, group)]


def mesh_rank(rank: int, world: int) -> dict:
    """Mesh shapes, coordinates, groups and batch rows of each of
    ``MESHES``; the errors of a mesh too large and of a batch that does
    not divide the data axis; the collectives' results."""
    out = {}
    for name, cfg in MESHES.items():
        mesh = make_mesh(cfg, device="cpu")
        rows = batch_sharding(mesh, 8)
        try:
            batch_sharding(mesh, 3)
            indivisible = None
        except ValueError as e:
            indivisible = str(e)
        out[name] = {
            "shape": dict(mesh.shape), "coords": dict(mesh.coords),
            "device": str(mesh.device), "backend": dist.get_backend(),
            "members": {axis: _members(mesh.groups[axis])
                        for axis in (DATA_AXIS, POINT_AXIS)},
            "rows": (rows.start, rows.stop), "indivisible": indivisible,
        }
    try:
        make_mesh(MeshConfig(4, 2), device="cpu")
        out["too_large"] = None
    except ValueError as e:
        out["too_large"] = str(e)

    # rank r holds r + 1 rows of the value r
    sizes = [r + 1 for r in range(world)]
    block = torch.full((rank + 1, 2), rank, dtype=torch.int32)
    out["gathered"] = collectives.all_gather_rows(block, sizes)
    # d/dx of sum_r (r + 1) * all_reduce_sum(x_r^2) is 2 x_r sum_r (r + 1)
    x = torch.tensor([float(rank + 1)], requires_grad=True)
    y = collectives.all_reduce_sum(x * x)
    (y * (rank + 1)).sum().backward()
    out["reduced"], out["grad"] = float(y.detach()), float(x.grad)
    return out


def pyramid_rank(rank: int, world: int, clouds: dict, k: int, ratios,
                 shard_min: int, thresholds) -> dict:
    """On the sp4 mesh, at each grid threshold (``GRID_THRESHOLD``: the
    level size above which the pyramid runs the cell-window search): for
    each (N, 3) cloud, whether ``build_pyramid_sharded`` equals
    ``build_pyramid_batch`` in every field, bit for bit, and how many
    levels were split; rank 0 also returns the sharded pyramids."""
    from pointunet_tpu_torch.ops import pyramid, pyramid_sharded

    mesh = make_mesh(MESHES["sp4"], device="cpu")
    gathers = []
    gather = pyramid_sharded.all_gather_rows

    def counted(t, sizes, group):
        gathers.append(tuple(sizes))
        return gather(t, sizes, group)

    pyramid_sharded.all_gather_rows = counted
    out = {}
    default = pyramid.GRID_THRESHOLD
    try:
        for threshold in thresholds:
            pyramid.GRID_THRESHOLD = threshold
            for name, xyz in clouds.items():
                gathers.clear()
                got = pyramid_sharded.build_pyramid_sharded(
                    xyz[None], k, ratios, mesh, shard_min=shard_min)
                want = pyramid.build_pyramid_batch(xyz[None], k, ratios)
                equal = all(
                    all(torch.equal(a, b) for a, b in zip(g, w))
                    if isinstance(g, tuple) else torch.equal(g, w)
                    for g, w in zip(got, want)
                )
                out[(threshold, name)] = {
                    "equal": equal, "gathers": list(gathers),
                    "pyramid": got if rank == 0 else None,
                }
    finally:
        pyramid.GRID_THRESHOLD = default
        pyramid_sharded.all_gather_rows = gather
    return out


def knn_sharded_rank(rank: int, world: int, clouds, k: int) -> dict:
    """``knn_point_sharded`` of each x-sorted cloud of ``clouds`` on the
    sp4 mesh: this rank holds its x-slab (near-equal contiguous blocks)
    and returns its rows' neighbours."""
    from pointunet_tpu_torch.ops.knn_sharded import knn_point_sharded
    from pointunet_tpu_torch.ops.pyramid_sharded import slab_sizes

    mesh = make_mesh(MESHES["sp4"], device="cpu")
    sizes = slab_sizes(clouds[0].shape[0], world)
    lo = sum(sizes[:rank])
    rows = slice(lo, lo + sizes[rank])
    return {"rows": (rows.start, rows.stop),
            "idx": [knn_point_sharded(xyz[rows], k, mesh) for xyz in clouds]}


def _trainer(cfg, state_dict, mesh, shard_min):
    from pointunet_tpu_torch.train.pointseg import PointSegTrainer

    trainer = PointSegTrainer(cfg, device="cpu", mesh=mesh,
                              point_shard_min=shard_min)
    state = trainer.init_state()
    # a copy: the optimizer takes the moments' tensors as they are, and
    # its steps would update them in place
    state.load_state_dict(copy.deepcopy(state_dict))
    return trainer, state


def _steps(trainer, state, batch, steps: int) -> list:
    """``steps`` train steps on this rank's rows of ``batch``: the loss,
    accuracy, summed gradients, parameters and batch-norm statistics of
    each."""
    out = []
    for _ in range(steps):
        _, m = trainer.train_step(state, *trainer.shard_batch(*batch))
        model = state.model
        out.append({
            "loss": float(m["loss"]), "acc": float(m["acc"]),
            "grads": {n: p.grad.clone() for n, p in model.named_parameters()},
            "params": {n: p.detach().clone()
                       for n, p in model.named_parameters()},
            "buffers": {n: b.clone() for n, b in model.named_buffers()},
        })
    return out


def train_rank(rank: int, world: int, cfgs: dict, state_dict: dict, batch,
               steps: int, shard_min: int) -> dict:
    """For the dp4 and dp2sp2 meshes, from ``state_dict``: ``evaluate``'s
    mean IoU on ``batch``, then ``steps`` steps at each config of
    ``cfgs`` (``_steps``), and how many pyramids were built by the
    point-sharded path; on dp2sp2, the gradient an update takes when each
    rank's own is its rank + 1. Each rank takes its rows of ``batch``
    (xyz, feats, labels: the global batch)."""
    from pointunet_tpu_torch.train import pointseg

    sharded = []
    build = pointseg.build_pyramid_sharded

    def counted(*a, **kw):
        sharded.append(1)
        return build(*a, **kw)

    pointseg.build_pyramid_sharded = counted
    out = {}
    try:
        for name in ("dp4", "dp2sp2"):
            mesh = make_mesh(MESHES[name], device="cpu")
            sharded.clear()
            res = {}
            for key, cfg in cfgs.items():
                trainer, state = _trainer(cfg, state_dict, mesh, shard_min)
                if "miou" not in res:
                    res["miou"] = trainer.evaluate(state, [batch],
                                                   log=lambda *a: None)
                res[key] = _steps(trainer, state, batch, steps)
            res["sharded_pyramids"] = len(sharded)
            out[name] = res
        # the gradient each rank's update takes when the ranks' own
        # differ: rank r's is r + 1 everywhere (on dp2sp2)
        trainer, state = _trainer(cfgs["no_dropout"], state_dict, mesh,
                                  shard_min)
        for p in state.model.parameters():
            p.grad = torch.full_like(p, rank + 1.0)
        trainer.apply_update(state)
        out["synced_grads"] = sorted({
            float(v) for p in state.model.parameters() for v in p.grad.unique()
        })
    finally:
        pointseg.build_pyramid_sharded = build
    return out


@contextlib.contextmanager
def low_gate(threshold: int):
    """Within: levels of more than ``threshold`` rows run the pyramid's
    cell-window search, and every sorted gather's backward above them
    takes the sorted scatter's plan (``MIN_ROWS`` 0: valid because the
    indices come from the windowed search). Yields the list of the ct
    rows and support rows of each ``scatter_sorted`` call."""
    from pointunet_tpu_torch.ops import pyramid
    from pointunet_tpu_torch.ops import scatter_sorted as ss

    calls, scatter = [], ss.scatter_sorted
    saved = (pyramid.GRID_THRESHOLD, ss.GRID_THRESHOLD, ss.MIN_ROWS)

    def record(ct, idx, s_ids, *args):
        calls.append((ct.shape[0], s_ids.shape[0]))
        return scatter(ct, idx, s_ids, *args)

    pyramid.GRID_THRESHOLD = ss.GRID_THRESHOLD = threshold
    ss.MIN_ROWS = 0
    ss.scatter_sorted = record
    try:
        yield calls
    finally:
        pyramid.GRID_THRESHOLD, ss.GRID_THRESHOLD, ss.MIN_ROWS = saved
        ss.scatter_sorted = scatter


def _gather_case(rank: int) -> dict:
    """``all_gather_rows_grad`` of f64 slabs of 3, 1, 4 and 2 rows, and the
    gradient of sum(whole * w) with a weight table w of this rank's."""
    sizes = [3, 1, 4, 2]
    gen = torch.Generator().manual_seed(rank)
    t = torch.randn((sizes[rank], 5), generator=gen, dtype=torch.float64)
    w = torch.randn((sum(sizes), 5), generator=gen, dtype=torch.float64)
    t.requires_grad_(True)
    whole = collectives.all_gather_rows_grad(t, sizes)
    (whole * w).sum().backward()
    return {"t": t.detach(), "w": w, "whole": whole.detach(),
            "grad": t.grad, "sizes": sizes}


SHARDED_MESHES = ("sp4", "dp2sp2")


def point_sharded_rank(rank: int, world: int, cfgs: dict, state_dict: dict,
                       batch, steps: int, shard_min: int,
                       low_threshold: int) -> dict:
    """The activation-sharded point net on the sp4 and dp2sp2 meshes,
    from ``state_dict``: this rank's batch rows and level-0 slab; the
    train-mode and eval-mode logits of its clouds, gathered over the point
    group; ``steps`` train steps (``_steps``) at the default gates and
    under ``low_gate(low_threshold)`` with the sorted scatter calls made
    there; the dropout keep-mask of its slab. Also ``_gather_case``."""
    from pointunet_tpu_torch.ops.pyramid import take_level0

    out = {"gather": _gather_case(rank)}
    cfg = cfgs["no_dropout"]
    for name in SHARDED_MESHES:
        mesh = make_mesh(MESHES[name], device="cpu")
        rows = batch_sharding(mesh, len(batch[0]))
        trainer, state = _trainer(cfg, state_dict, mesh, shard_min)
        xyz, feats, _ = trainer.shard_batch(*batch)
        pyr = trainer.pyramid_fn(xyz)
        f0 = take_level0(pyr, feats)
        model = state.model
        slab = model.slab(f0.shape[1])
        with torch.no_grad():
            logits = {mode: slab.whole(
                getattr(model, mode)()(f0[:, slab.rows], pyr))
                for mode in ("train", "eval")}
        res = {"rows": (rows.start, rows.stop),
               "slab": (slab.rows.start, slab.rows.stop), "logits": logits}
        trainer, state = _trainer(cfg, state_dict, mesh, shard_min)
        res["steps"] = _steps(trainer, state, batch, steps)
        with low_gate(low_threshold) as calls:
            trainer, state = _trainer(cfg, state_dict, mesh, shard_min)
            res["low_steps"] = _steps(trainer, state, batch, steps)
        res["low_scatters"] = list(calls)
        trainer, state = _trainer(cfgs["dropout"], state_dict, mesh,
                                  shard_min)
        res["keep"] = state.model._dropout_keep(
            (len(xyz), slab.rows.stop - slab.rows.start, 32), "cpu",
            cfgs["dropout"].dropout_rate, torch.Generator().manual_seed(7),
            f0.shape[1], slab.rows)
        out[name] = res
    return out


def fail_on_rank(rank: int, world: int, bad: int) -> int:
    """Raises on rank ``bad``; the others return their rank."""
    if rank == bad:
        raise ValueError(f"rank {rank} fails on purpose")
    return rank


def fused_rank(rank: int, world: int, sal_state: dict, pseg_state: dict,
               cfgs, mods, seeds, volume) -> dict:
    """``segment_batch_device`` of ``mods`` on the dp2sp2 mesh with the
    given weights: the labels this rank returns, and how many volumes it
    segmented itself."""
    from pointunet_tpu_torch.models.randlanet import RandLANet
    from pointunet_tpu_torch.models.saliency_unet import SaliencyUNet
    from pointunet_tpu_torch.pipeline.fused import FusedPointUnet

    scfg, pcfg = cfgs
    sal, pseg = SaliencyUNet(scfg), RandLANet(pcfg)
    sal.load_state_dict(sal_state)
    pseg.load_state_dict(pseg_state)
    pipe = FusedPointUnet(sal.eval(), pseg.eval(), scfg, pcfg, threshold=0.5,
                          volume_shape=volume, device="cpu")
    segmented = []
    segment = pipe.segment_device

    def counted(*a):
        segmented.append(1)
        return segment(*a)

    pipe.segment_device = counted
    mesh = make_mesh(MESHES["dp2sp2"], device="cpu")
    labels = pipe.segment_batch_device(mods, seeds, mesh=mesh)
    return {"labels": labels, "segmented": len(segmented)}
