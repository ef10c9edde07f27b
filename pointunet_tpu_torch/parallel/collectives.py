"""Collectives of the (data, point) mesh, and the launcher of its ranks.

The reference lets XLA insert its collectives (GSPMD, ``shard_map``); the
port calls them itself, and uses only list-form ``all_gather`` and
``all_reduce``: no point-to-point ``send``/``recv``. Those two take CUDA
tensors under both backends, so the ranks that share one card over gloo
never move their compute off it.

* ``all_gather_rows``: the row blocks of every rank of a group, which may
  differ in length, concatenated in rank order on every rank (each block
  is padded to the longest, gathered and sliced back).
* ``all_gather_rows_grad``: the same gather, differentiable: a rank's
  slab goes in and the whole table comes out, and the backward sums the
  whole table's cotangent over the group in f32 at least (one
  ``all_reduce``: gloo has no ``reduce_scatter``) and keeps this rank's
  slab. The activation-sharded point net makes each gather's source
  table whole with it.
* ``all_reduce_sum``: a sum over a group that autograd differentiates:
  its backward sums the incoming gradients over the group, because every
  rank's loss depends on the sum
  (``torch.distributed.nn.functional.all_reduce`` does the same and is
  deprecated).
* ``all_reduce_``: the in-place sum, outside autograd.
* ``spawn``: starts ``world`` ranks of a function in fresh processes with
  a file rendezvous in a new temporary directory (no port is reserved, so
  any number of launches may run side by side), and returns their
  results in rank order; a rank that raises fails the launch.
"""
from __future__ import annotations

import os
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# seconds a launch waits for its ranks (``spawn``)
SPAWN_TIMEOUT_S = 900


def all_gather_rows(
    t: torch.Tensor, sizes: Sequence[int], group=None
) -> torch.Tensor:
    """Rank j of ``group`` holds ``t`` with ``sizes[j]`` rows; every rank
    gets the blocks of all ranks concatenated in rank order."""
    rows = max(sizes)
    if t.shape[0] != sizes[dist.get_rank(group)]:
        raise ValueError(
            f"all_gather_rows: this rank holds {t.shape[0]} rows, the sizes "
            f"say {sizes[dist.get_rank(group)]}"
        )
    pad = t.new_zeros((rows - t.shape[0],) + tuple(t.shape[1:]))
    block = torch.cat([t, pad]) if pad.shape[0] else t.contiguous()
    out = [torch.empty_like(block) for _ in sizes]
    dist.all_gather(out, block, group=group)
    return torch.cat([o[:n] for o, n in zip(out, sizes)])


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, sizes, group):
        ctx.sizes, ctx.group = sizes, group
        return all_gather_rows(t, sizes, group)

    @staticmethod
    def backward(ctx, grad):
        # summed in f32 at least: a bf16 table's cotangent too
        acc = torch.promote_types(grad.dtype, torch.float32)
        whole = all_reduce_(grad.to(acc, copy=True).contiguous(), ctx.group)
        rank = dist.get_rank(ctx.group)
        lo = sum(ctx.sizes[:rank])
        return whole[lo:lo + ctx.sizes[rank]].to(grad.dtype), None, None


def all_gather_rows_grad(
    t: torch.Tensor, sizes: Sequence[int], group=None
) -> torch.Tensor:
    """``all_gather_rows``, differentiable: every rank's loss may read any
    row of the whole table, so the backward sums the table's cotangent
    over ``group`` and returns this rank's rows of the sum (the same bytes
    on every rank)."""
    return _AllGatherRows.apply(t, tuple(sizes), group)


def all_reduce_(t: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum of ``t`` over ``group``; returns ``t``."""
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, t):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return None, all_reduce_(grad.clone(), ctx.group)


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of ``t`` over ``group`` on every rank, differentiable."""
    return _AllReduceSum.apply(group, t)


def _rank_main(fn, rank, world, store_path, backend, device, args, results):
    from .mesh import init_distributed

    torch.set_num_threads(1)
    try:
        init_distributed(backend, device, rank=rank, world_size=world,
                         store=dist.FileStore(store_path, world))
        out = pickle.dumps(fn(rank, world, *pickle.loads(args)))
        results.put((rank, True, out))
    except BaseException:      # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(
    fn: Callable, world: int, *args, backend=None, device: str = "cuda",
    timeout: float = SPAWN_TIMEOUT_S,
) -> List:
    """Run ``fn(rank, world, *args)`` on ``world`` new processes joined in
    one process group (``init_distributed(backend, device)``), and return
    the ranks' results in rank order. ``fn`` and ``args`` are pickled:
    ``fn`` must be importable by its module's name, and a script that
    calls ``spawn`` guards its own work by ``if __name__ == "__main__"``
    (each rank imports it). Arguments and results travel by value. If a rank raises or
    dies, the others are stopped and a ``RuntimeError`` says which (with
    its traceback where it raised)."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="pointunet_rdzv_")
    store = os.path.join(tmp, "store")
    # arguments and results are pickled by value: torch's process pickler
    # would share a tensor's memory between the ranks (and the parent),
    # so that one rank's in-place update reached the others, and a result
    # shared by a rank that has ended could not be read
    payload = pickle.dumps(args)
    procs = [
        ctx.Process(target=_rank_main, daemon=True, args=(
            fn, r, world, store, backend, device, payload, results))
        for r in range(world)
    ]
    try:
        for p in procs:
            p.start()
        got = {}
        deadline = time.monotonic() + timeout
        # read every result before joining: a rank's queue feeder blocks
        # on a full pipe
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode is not None]
                if dead:
                    raise RuntimeError(
                        f"spawn: rank {dead[0]} of {world} ended with exit "
                        f"code {procs[dead[0]].exitcode} and no result"
                    ) from None
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"spawn: {world - len(got)} of {world} ranks gave no "
                        f"result within {timeout} s"
                    ) from None
                continue
            if not ok:
                raise RuntimeError(
                    f"spawn: rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout)
        return [pickle.loads(got[r]) for r in range(world)]
    finally:
        for p in procs:
            if p.pid is None:           # never started
                continue
            if p.is_alive():
                p.kill()
            p.join(10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
