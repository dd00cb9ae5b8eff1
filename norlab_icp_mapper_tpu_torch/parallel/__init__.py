"""The collective layer of the port: one rank per device over
``torch.distributed`` (``multihost``), scan-to-map ICP with the map split
over the ranks (``distributed``), and the sharded per-scan mapper
(``sharded_map``: ``ShardedMapConfig``, ``ShardedMapperStep``,
``ShardedMapper``), which ``Mapper(config, mesh=...)`` drives."""
from .distributed import make_mesh, DistributedICP, shard_points
from .sharded_map import ShardedMapConfig, ShardedMapperStep, ShardedMapper
from . import multihost

__all__ = ["make_mesh", "DistributedICP", "shard_points", "multihost",
           "ShardedMapConfig", "ShardedMapperStep", "ShardedMapper"]
