"""Name -> factory registries with parameter schemas.

Equivalent of libpointmatcher's ``Parametrizable`` + registrar
machinery used throughout the reference (``MapperModule.h:12``,
``Mapper.h:69-70``, ``Mapper.cpp:9-13,169``): each plugin declares a
parameter schema (doc, default, type, optional min/max); the factory
validates values, applies defaults, range-checks, and rejects unknown
parameters (the reference warns on unused params,
``OctreeMapperModule.cpp:6-11`` — here it is a hard error, stricter but
safer).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

__all__ = ["Param", "Registry", "ParametrizedPlugin"]


@dataclasses.dataclass(frozen=True)
class Param:
    doc: str
    default: Any
    type: type = float
    min: Optional[float] = None
    max: Optional[float] = None


def _coerce(p: Param, raw: Any):
    if p.type is bool:
        if isinstance(raw, bool):
            return raw
        if isinstance(raw, (int, float)):
            return bool(raw)
        s = str(raw).strip().lower()
        return s in ("1", "true", "yes")
    v = p.type(raw)
    if p.min is not None and v < p.min:
        raise ValueError(f"parameter value {v} below minimum {p.min}")
    if p.max is not None and v > p.max:
        raise ValueError(f"parameter value {v} above maximum {p.max}")
    return v


class ParametrizedPlugin:
    """Base for filters / mapper modules. Subclasses set ``NAME`` and
    ``PARAMS: dict[str, Param]``; validated values land in ``self.params``."""

    NAME: str = ""
    PARAMS: Dict[str, Param] = {}

    def __init__(self, params: Optional[Dict[str, Any]] = None):
        params = dict(params or {})
        resolved = {}
        for key, spec in self.PARAMS.items():
            if key in params:
                try:
                    resolved[key] = _coerce(spec, params.pop(key))
                except (TypeError, ValueError) as e:
                    raise ValueError(
                        f"{self.NAME}: invalid value for parameter '{key}': {e}")
            else:
                if spec.default is None:
                    raise ValueError(f"{self.NAME}: missing required parameter '{key}'")
                resolved[key] = spec.default
        if params:
            raise ValueError(
                f"{self.NAME}: unknown parameter(s) {sorted(params)}; "
                f"available: {sorted(self.PARAMS)}")
        self.params = resolved

    # mirrors the reference's per-plugin introspection statics bound to
    # Python (``python/src/mappermodules/dynamic_points.cpp:10-24``)
    @classmethod
    def description(cls) -> str:
        return (cls.__doc__ or "").strip().splitlines()[0] if cls.__doc__ else cls.NAME

    @classmethod
    def available_parameters(cls) -> Dict[str, Dict[str, Any]]:
        return {
            k: {"doc": p.doc, "default": p.default, "type": p.type.__name__,
                "min": p.min, "max": p.max}
            for k, p in cls.PARAMS.items()
        }


class Registry:
    """String-keyed plugin registry (one per plugin kind)."""

    def __init__(self, kind: str):
        self.kind = kind
        self._factories: Dict[str, Callable[..., Any]] = {}

    def register(self, cls):
        name = getattr(cls, "NAME", None) or cls.__name__
        self._factories[name] = cls
        return cls

    def names(self):
        return sorted(self._factories)

    def get(self, name: str):
        if name not in self._factories:
            raise KeyError(
                f"unknown {self.kind} '{name}'; available: {self.names()}")
        return self._factories[name]

    def create(self, name: str, params: Optional[Dict[str, Any]] = None):
        return self.get(name)(params or {})

    def create_from_yaml_entry(self, entry):
        """Instantiate from a YAML list element: either a bare name string or
        a one-key mapping ``{Name: {param: value, ...}}`` (the shape used by
        reference configs, ``examples/config.yaml``)."""
        if isinstance(entry, str):
            return self.create(entry, {})
        if isinstance(entry, dict):
            if len(entry) != 1:
                raise ValueError(
                    f"{self.kind} entry must have exactly one key, got {sorted(entry)}")
            name, params = next(iter(entry.items()))
            return self.create(name, params or {})
        raise ValueError(f"invalid {self.kind} YAML entry: {entry!r}")
