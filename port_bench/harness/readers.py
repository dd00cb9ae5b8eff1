"""Arithmetic shared by the per-layer metric files under ``metrics/``."""
from __future__ import annotations

import re
from typing import Optional

# the published bandwidth of one NVIDIA H100 SXM (NVIDIA's data sheet); the
# nearest-neighbour roofline counts no operations, so its peak rate of
# 67 TFLOP/s in float32 never bounds it
PEAK_HBM_BYTES = 3.35e12


def per_scan(total: Optional[float], ctx) -> Optional[float]:
    if total is None or not ctx.scans:
        return None
    return total / ctx.scans


def waits_per_scan(ctx) -> Optional[float]:
    return per_scan(float(sum(ctx.waits.values())), ctx)


def phase_ms_per_scan(ctx, phase: str) -> Optional[float]:
    return per_scan(ctx.phases_ms.get(phase), ctx)


def device_idle_pct(ctx) -> Optional[float]:
    p = ctx.profile
    if not p or p["window_s"] <= 0 or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])


_TEMPLATE = re.compile(r"(sweep_knn|knn_brute)_kernel<(\d+), (\d+)")


def nn_call_bytes(family: str, dim: int, k: int, shapes: dict) -> float:
    """The bytes every implementation of one nearest-neighbour call must
    move: each query row's coordinates and mask byte read once, each valid
    reference's coordinates read once, each of the ``k`` neighbours written
    once as a float32 distance and an int32 index.  No pair-loop
    operations: a change of search algorithm cannot do less."""
    scan, map_valid = shapes["scan_rows"], shapes["map_valid"]
    if family == "sweep_knn" and dim == 2:
        n_query, n_ref, k = map_valid, scan, 1  # map beams to scan beams
    elif family == "knn_brute" and k > 4:
        n_query, n_ref, k = map_valid, map_valid, 10  # k-NN normals
    else:
        n_query, n_ref = scan, map_valid  # the matcher, PointDistance
    return n_query * (4 * dim + 1) + n_ref * 4 * dim + n_query * k * 8


def nn_roofline_pct(ctx, families) -> Optional[float]:
    """The least time of the traced slice's nearest-neighbour calls over
    their device time (percent)."""
    p = ctx.profile
    if not p or ctx.shapes.get("map_valid") is None:
        return None
    device_s, least_s = 0.0, 0.0
    for name, seconds in p["kernels"].items():
        if not any(f in name for f in families):
            continue
        device_s += seconds
    for name, calls in p.get("kernel_calls", {}).items():
        m = _TEMPLATE.search(name)
        if m is None or m.group(1) not in families:
            continue
        b = nn_call_bytes(m.group(1), int(m.group(2)), int(m.group(3)),
                          ctx.shapes)
        least_s += calls * b / PEAK_HBM_BYTES
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
