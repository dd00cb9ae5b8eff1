from .core import (
    DataPointsFilter,
    FilterChain,
    filter_registry,
)

__all__ = ["DataPointsFilter", "FilterChain", "filter_registry"]
