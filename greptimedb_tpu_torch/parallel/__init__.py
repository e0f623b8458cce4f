"""Distribution layer: the device mesh and the collective aggregation.

Torch counterpart of the reference's ``parallel/`` package, its mesh row
path (``dist.py``): the series axis of a table sharded across a mesh of
devices, the commutativity split computing partial aggregates on each
shard, and ``ops/mesh_kernels.mesh_merge`` in place of the reference's
XLA collectives.  Partition rules (``partition.py``) are not ported.
"""

from greptimedb_tpu_torch.parallel.dist import (
    DistAggExecutor,
    ShardedTable,
    create_mesh,
    shard_table,
)

__all__ = [
    "ShardedTable",
    "create_mesh",
    "shard_table",
    "DistAggExecutor",
]
