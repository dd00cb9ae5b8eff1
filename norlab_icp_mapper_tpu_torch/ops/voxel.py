"""Voxel-grid bucketing utilities (sort-based, fixed-shape).

The octree decimation of libpointmatcher subdivides until leaves are smaller
than ``maxSizeByNode`` -- functionally a (near-)uniform spatial decimation.
Here that is a uniform voxel grid: integer voxel coordinates per axis, one
stable sort groups voxel members, segment boundaries mark representatives.
Invalid points sort last.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["voxel_coords", "voxel_select"]


def voxel_coords(positions: torch.Tensor, voxel_size) -> torch.Tensor:
    """Integer voxel coordinate per point, i32[N, D]."""
    return torch.floor(positions / voxel_size).to(torch.int32)


def _segment_sum(values: torch.Tensor, seg_id: torch.Tensor,
                 n: int) -> torch.Tensor:
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    return out.index_add_(0, seg_id, values)


def _segment_min(values: torch.Tensor, seg_id: torch.Tensor, n: int,
                 fill) -> torch.Tensor:
    out = torch.full((n,), fill, dtype=values.dtype, device=values.device)
    return out.scatter_reduce_(0, seg_id, values, reduce="amin",
                               include_self=True)


def voxel_select(
    positions: torch.Tensor,  # f32[N, D]
    mask: torch.Tensor,  # bool[N]
    voxel_size,
    method: int = 0,  # 0=first point, 1=random, 2=centroid, 3=medoid
    prio15: Optional[torch.Tensor] = None,  # int[N] in [0, 2**15), method=1
    max_point_by_node: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One representative per voxel.

    Returns ``(keep_mask bool[N], centroid f32[N, D])``.  ``keep_mask`` marks
    representative points; ``centroid`` carries the per-point voxel centroid
    (meaningful only where keep_mask, used by samplingMethod=2).  Sampling
    modes of lpm's octree filter: 0 = first point, 1 = random point,
    2 = centroid, 3 = medoid.

    ``prio15`` are the random tie-break priorities of method 1 (the caller
    draws them; see ``draws.py``).  Points sort stably by
    ``(invalid, x, y, z, prio15)``, so the lowest priority in a voxel wins
    and equal priorities keep input order.

    ``max_point_by_node > 1`` (lpm's hierarchical coarsening of sparse
    regions) is not ported yet.
    """
    if max_point_by_node > 1:
        raise NotImplementedError(
            "voxel_select with maxPointByNode > 1 (_octree_select, the "
            "hierarchical octree leaf selection) is not ported yet")
    n, dim = positions.shape
    vc = voxel_coords(positions, voxel_size)  # i32[N, D]
    invalid = ~mask

    # ONE stable sort on an int64 key.  Voxel coords are rebased to the
    # masked minimum and packed 15 bits per axis:
    #   invalid<<60 | x<<45 | y<<30 | z<<15 | prio15      (D=3)
    #   invalid<<60 | x<<30 | y<<15 | prio15              (D=2)
    # the same order as the reference's two-key i32 sort.  Coords clipped
    # at 32767 may share packed keys, but grouping compares the TRUE coords
    # below, so clipping can only under-merge (keep extra representatives),
    # never wrongly merge distinct voxels.
    big = 1 << 30
    vmin = torch.where(mask[:, None], vc, torch.full_like(vc, big)).amin(0)
    rel = torch.clamp(vc - vmin, 0, 32767).to(torch.int64)
    if method == 1:
        if prio15 is None:
            raise ValueError("voxel_select method 1 needs prio15 draws")
        prio = prio15.to(device=positions.device, dtype=torch.int64)
    else:
        prio = torch.zeros((n,), dtype=torch.int64, device=positions.device)
    if dim == 3:
        key = (rel[:, 0] << 45) | (rel[:, 1] << 30) | (rel[:, 2] << 15) | prio
    else:
        key = (rel[:, 0] << 30) | (rel[:, 1] << 15) | prio
    key = key | (invalid.to(torch.int64) << 60)
    order = torch.sort(key, stable=True).indices

    sc = vc[order]  # sorted coords
    sv = mask[order]  # sorted validity
    same_as_prev = torch.cat([
        torch.zeros((1,), dtype=torch.bool, device=positions.device),
        torch.all(sc[1:] == sc[:-1], dim=1) & sv[1:] & sv[:-1],
    ])
    is_first = (~same_as_prev) & sv

    if method in (0, 1):
        keep = torch.zeros((n,), dtype=torch.bool, device=positions.device)
        keep[order] = is_first
        return keep, positions

    # centroid / medoid need per-voxel means
    seg_id = torch.clamp(torch.cumsum(is_first.to(torch.int64), 0) - 1, min=0)
    sorted_pos = positions[order]
    w = sv.to(torch.float32)[:, None]
    sums = _segment_sum(sorted_pos * w, seg_id, n)
    cnts = _segment_sum(w, seg_id, n)
    means_per_seg = sums / torch.clamp(cnts, min=1.0)
    sorted_centroid = means_per_seg[seg_id]

    if method == 2:
        keep_sorted = is_first
    else:  # medoid: point closest to its voxel centroid
        d2 = torch.sum((sorted_pos - sorted_centroid) ** 2, dim=1)
        d2 = torch.where(sv, d2, torch.full_like(d2, float("inf")))
        seg_min = _segment_min(d2, seg_id, n, float("inf"))
        is_min = d2 <= seg_min[seg_id]
        iota = torch.arange(n, device=positions.device)
        first_min_rank = _segment_min(
            torch.where(is_min, iota, torch.full_like(iota, n)), seg_id, n, n)
        keep_sorted = (iota == first_min_rank[seg_id]) & sv

    keep = torch.zeros((n,), dtype=torch.bool, device=positions.device)
    keep[order] = keep_sorted
    centroid = torch.zeros_like(positions)
    centroid[order] = sorted_centroid
    return keep, centroid
