"""The (data, point) mesh of ``torch.distributed`` ranks
(``pointunet_tpu/parallel/mesh.py``).

The reference builds a JAX ``Mesh`` over devices and lets GSPMD shard
arrays on it. The port runs one process a rank, each with an explicit
device, and gives each rank one process group along each axis:

* ``data``: ranks that hold different rows of the batch (volumes or
  clouds);
* ``point``: ranks that hold the same clouds, build the same pyramid
  (sharing its large searches, ``ops/pyramid_sharded.py``) and split
  the point net's activations: rank p computes slab p of every level's
  rows (``RandLANet(point_group=)``), as the reference's ``_pshard``
  anchors them on this axis.

The rows of a global batch are then spread over the whole mesh: the
batch norms, the loss's sums and the gradient sum run over ``group``,
the group of every rank (the default group: the mesh covers the world).

Rank ``r`` sits at ``(r // point, r % point)``, as the reference's
``devices.reshape(data, point)``. ``init_distributed`` joins the process
group: ``nccl`` when every rank has a card of its own, ``gloo`` on the
CPU or when ranks share a card (NCCL refuses two ranks on one card). The
backend changes nothing else. Under ``torchrun``, a script calls
``init_distributed()`` then ``make_mesh(MeshConfig(...))``.
"""
from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from ..core.config import MeshConfig

DATA_AXIS = "data"
POINT_AXIS = "point"

log = logging.getLogger(__name__)


def choose_backend(device: str, ranks_per_host: int) -> str:
    """``nccl`` when the ranks are on CUDA and each one of the host's
    ``ranks_per_host`` ranks has a card of its own; else ``gloo``."""
    if (torch.device(device).type == "cuda"
            and ranks_per_host <= torch.cuda.device_count()):
        return "nccl"
    return "gloo"


def init_distributed(
    backend: Optional[str] = None,
    device: str = "cuda",
    *,
    rank: Optional[int] = None,
    world_size: Optional[int] = None,
    store=None,
) -> torch.device:
    """Join the default process group and return this rank's device.

    Without ``rank``/``world_size``/``store`` it reads ``torchrun``'s
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``). The device is
    ``cuda:<local rank % cards>`` (or the CPU); ``backend`` None chooses
    by ``choose_backend`` and logs the choice."""
    if rank is None:
        rank = int(os.environ["RANK"])
        world_size = int(os.environ["WORLD_SIZE"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
    else:
        local_rank, per_host = rank, world_size
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init_distributed: no CUDA device; pass device='cpu' to run "
                "the ranks on the CPU"
            )
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    if backend is None:
        backend = choose_backend(device, per_host)
    log.info("init_distributed: rank %d of %d on %s, backend %s",
             rank, world_size, dev, backend)
    kwargs = {} if store is None else {"store": store}
    dist.init_process_group(backend, rank=rank, world_size=world_size,
                            **kwargs)
    return dev


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the (data, point) mesh: the mesh ``shape`` and
    this rank's ``coords`` by axis name, its ``groups`` (the ranks that
    share its other coordinate, one group an axis), the ``group`` of
    every rank of the mesh and its ``device``."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]
    group: object
    device: torch.device


def make_mesh(cfg: Optional[MeshConfig] = None, device: str = "cuda") -> Mesh:
    """The (data, point) mesh over the default group's ranks. Default: all
    ranks on the data axis. Every rank must call it, in the same order as
    any other group it makes. ``device`` "cuda" means the card
    ``init_distributed`` gave this rank."""
    world = dist.get_world_size()
    if cfg is None:
        cfg = MeshConfig(data=world, point=1)
    n = cfg.data * cfg.point
    if n != world:
        raise ValueError(
            f"mesh {cfg.data}x{cfg.point} needs {n} ranks, have {world}"
        )
    rank = dist.get_rank()
    data_groups = [
        dist.new_group([d * cfg.point + p for d in range(cfg.data)])
        for p in range(cfg.point)
    ]
    point_groups = [
        dist.new_group([d * cfg.point + p for p in range(cfg.point)])
        for d in range(cfg.data)
    ]
    d, p = divmod(rank, cfg.point)
    return Mesh(
        shape={DATA_AXIS: cfg.data, POINT_AXIS: cfg.point},
        coords={DATA_AXIS: d, POINT_AXIS: p},
        groups={DATA_AXIS: data_groups[p], POINT_AXIS: point_groups[d]},
        group=dist.group.WORLD,
        device=(torch.device("cuda", torch.cuda.current_device())
                if device == "cuda" else torch.device(device)),
    )


def batch_sharding(mesh: Mesh, batch: int) -> slice:
    """This rank's rows of a global batch of ``batch``: the data axis
    splits it into equal contiguous blocks; point ranks receive theirs
    whole (the pyramid needs the whole cloud) and the point net takes
    each rank's slab of the level-0 rows after ``take_level0``."""
    dp = mesh.shape[DATA_AXIS]
    if batch % dp != 0:
        raise ValueError(f"batch {batch} not divisible by data axis {dp}")
    per = batch // dp
    d = mesh.coords[DATA_AXIS]
    return slice(d * per, (d + 1) * per)


def shard_batch(mesh: Mesh, *arrays) -> Tuple[torch.Tensor, ...]:
    """This rank's rows (``batch_sharding``) of each (B, ...) array or
    tensor, as tensors on the mesh's device."""
    if not arrays:
        return ()
    rows = batch_sharding(mesh, len(arrays[0]))
    out = []
    for a in arrays:
        if len(a) != len(arrays[0]):
            raise ValueError(
                f"shard_batch: batches of {len(arrays[0])} and {len(a)}")
        out.append(torch.as_tensor(a[rows]).to(mesh.device))
    return tuple(out)


def replicated(mesh: Mesh, t) -> torch.Tensor:
    """The whole of ``t`` on this rank's device (every rank holds it)."""
    return torch.as_tensor(t).to(mesh.device)
