from .core import (
    MapperModule,
    mapper_module_registry,
    PointDistanceMapperModule,
    OctreeMapperModule,
    DynamicPointsMapperModule,
)

__all__ = [
    "MapperModule", "mapper_module_registry", "PointDistanceMapperModule",
    "OctreeMapperModule", "DynamicPointsMapperModule",
]
