"""The configurations' input chain in plain tensor operations: the radius
filter at ``sensorMaxRange`` (the mapper's own, always first), then the
listed BoundingBox and AddDescriptor filters."""
from __future__ import annotations

import torch

DEFAULT_MAX_RANGE = 200.0  # m, the mapper's default


def input_chain(scan: torch.Tensor, cfg):
    """``(points f32[n, 3], probabilityDynamic f32[n] or None)`` of a raw
    sensor-frame scan."""
    mapper = (cfg or {}).get("mapper") or {}
    keep = torch.linalg.norm(scan, dim=1) <= float(
        mapper.get("sensorMaxRange", DEFAULT_MAX_RANGE))
    prob = None
    for f in (cfg or {}).get("input") or []:
        (name, p), = f.items()
        if name == "BoundingBoxDataPointsFilter":
            inside = torch.ones_like(keep)
            for a, axis in enumerate("xyz"):
                inside &= (scan[:, a] >= p[f"{axis}Min"]) & \
                    (scan[:, a] <= p[f"{axis}Max"])
            keep &= ~inside if p.get("removeInside", 1) else inside
        elif name == "AddDescriptorDataPointsFilter":
            if p["descriptorName"] != "probabilityDynamic":
                raise ValueError("reference: probabilityDynamic only")
            prob = float(p["descriptorValues"][0])
        else:
            raise ValueError(f"reference input chain: no filter {name}")
    pts = scan[keep]
    if prob is not None:
        prob = torch.full((pts.shape[0],), prob, device=scan.device)
    return pts, prob
