"""The collective layer of the port: one rank per device over
``torch.distributed`` (``multihost``), and scan-to-map ICP with the map
split over the ranks (``distributed``).  The sharded per-scan mapper of the
JAX package (``ShardedMapConfig``, ``ShardedMapperStep``, ``ShardedMapper``)
and ``Mapper(mesh=...)`` are not ported yet."""
from .distributed import make_mesh, DistributedICP, shard_points
from . import multihost

__all__ = ["make_mesh", "DistributedICP", "shard_points", "multihost"]
