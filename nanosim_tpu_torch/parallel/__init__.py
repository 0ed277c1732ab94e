"""Data-parallel slot sharding over ranks (one card each) with global read
numbering."""

from .mesh import HostGroup, shard_sim_batch_numbered  # noqa: F401
from .multihost import (  # noqa: F401
    MultiHostMetagenomeRunner,
    MultiHostModeRunner,
    init_distributed,
    merge_host_shards,
    rank_device,
)
