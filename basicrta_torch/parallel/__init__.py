"""Device meshes, sharded sampling and the multi-host helpers."""

from basicrta_torch.parallel.mesh import (
    make_mesh,
    lane_sharding,
    event_sharding,
    deal_columns,
    event_sharded_blocks,
    sharded_training_step,
)
from basicrta_torch.parallel.distributed import (
    initialize,
    is_multihost,
    host_residue_partition,
)

__all__ = [
    "make_mesh",
    "lane_sharding",
    "event_sharding",
    "deal_columns",
    "event_sharded_blocks",
    "sharded_training_step",
    "initialize",
    "is_multihost",
    "host_residue_partition",
]
