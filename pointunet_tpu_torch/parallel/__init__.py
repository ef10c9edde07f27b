"""Multi-device layer of the port (``pointunet_tpu/parallel``):
``torch.distributed`` ranks on a (data, point) mesh."""
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
