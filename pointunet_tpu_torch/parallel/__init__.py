"""Multi-device layer of the port (``pointunet_tpu/parallel``):
``torch.distributed`` ranks on a (data, point) mesh.

The reference's ``batch_point_sharding`` has no counterpart: it returns a
``NamedSharding`` of a batch over both mesh axes, and the port shards by
explicit slabs instead (each point rank receives its clouds whole and
keeps its own slab of every level's rows, ``RandLANet(point_group=)``)."""
from .mesh import (
    DATA_AXIS,
    POINT_AXIS,
    Mesh,
    batch_sharding,
    choose_backend,
    init_distributed,
    make_mesh,
    replicated,
    shard_batch,
)

__all__ = [
    "DATA_AXIS",
    "POINT_AXIS",
    "Mesh",
    "batch_sharding",
    "choose_backend",
    "init_distributed",
    "make_mesh",
    "replicated",
    "shard_batch",
]
