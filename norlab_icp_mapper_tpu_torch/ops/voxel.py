"""Voxel-grid bucketing utilities (sort-based, fixed-shape).

The octree decimation of libpointmatcher subdivides until leaves are smaller
than ``maxSizeByNode`` -- functionally a (near-)uniform spatial decimation.
Here that is a uniform voxel grid: integer voxel coordinates per axis, one
stable sort groups voxel members, segment boundaries mark representatives.
Invalid points sort last.  With ``maxPointByNode > 1`` sparse regions
coarsen as lpm's octree does (:func:`_octree_select`): one Morton-order sort
makes every ancestor cell a contiguous run.

Every pass is fixed-shape and reads nothing on the host: no ``unique``, no
``nonzero``, no ``.item()``; segment minima and sums are scatter reductions.
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
    max_coarsen_levels: int = 10,
    leaf_keys: Optional[torch.Tensor] = None,  # int[N] in [0, 2**30)
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One representative per voxel (per octree leaf when
    ``max_point_by_node > 1``).

    Returns ``(keep_mask bool[N], centroid f32[N, D])``.  ``keep_mask`` marks
    representative points; ``centroid`` carries the per-point voxel centroid
    (meaningful only where keep_mask, used by samplingMethod=2).  Sampling
    modes of lpm's octree filter: 0 = first point, 1 = random point,
    2 = centroid, 3 = medoid.

    ``prio15`` are the random tie-break priorities of method 1 (the caller
    draws them; see ``draws.py``).  Points sort stably by
    ``(invalid, x, y, z, prio15)``, so the lowest priority in a voxel wins
    and equal priorities keep input order.

    ``max_point_by_node`` = K reproduces lpm's octree stopping rule (a node
    subdivides while it holds MORE than K points AND is larger than
    ``maxSizeByNode``): with K > 1 a leaf up to ``2**max_coarsen_levels``
    voxels wide holding <= K points keeps ONE representative.  Method 1
    then also needs ``leaf_keys``, one random key per point in sorted
    order, whose smallest in a leaf picks its representative.
    """
    if max_point_by_node > 1:
        return _octree_select(positions, mask, voxel_size, method, prio15,
                              leaf_keys, int(max_point_by_node),
                              int(max_coarsen_levels))
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
    prio = _prio(method, prio15, n, positions.device)
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
        return _scatter_back(order, is_first), positions

    seg_id = torch.clamp(torch.cumsum(is_first.to(torch.int64), 0) - 1, min=0)
    return _centroid_select(positions, order, sv, is_first, seg_id, method)


def _prio(method, prio15, n, device):
    if method == 1:
        if prio15 is None:
            raise ValueError("voxel_select method 1 needs prio15 draws")
        return prio15.to(device=device, dtype=torch.int64)
    return torch.zeros((n,), dtype=torch.int64, device=device)


def _scatter_back(order, sorted_values):
    """``out[order] = sorted_values``: the sorted rows back in input order."""
    out = torch.zeros_like(sorted_values)
    out[order] = sorted_values
    return out


def _centroid_select(positions, order, sv, is_first, seg_id, method):
    """Methods 2 (centroid) and 3 (medoid) over the segments ``seg_id`` of
    the sorted rows; ``is_first`` marks each segment's first valid row.

    The segment sums accumulate in float64 and the mean rounds once to
    float32: the card's scatter-add sums in no fixed order, and float64
    makes the result independent of it (a sum of float32 coordinates is
    exact in float64 unless a segment's coordinates span about 29 binary
    orders of magnitude), so the card and the CPU pick the same
    representatives."""
    n = positions.shape[0]
    sorted_pos = positions[order]
    w = sv.to(torch.float64)[:, None]
    sums = _segment_sum(sorted_pos.to(torch.float64) * w, seg_id, n)
    cnts = _segment_sum(w, seg_id, n)
    means_per_seg = (sums / torch.clamp(cnts, min=1.0)).to(positions.dtype)
    sorted_centroid = means_per_seg[seg_id]

    if method == 2:
        keep_sorted = is_first
    else:  # medoid: point closest to its segment's centroid
        # squares summed in axis order, as separate operations: a reduction
        # over the axis may add in another order on the card, and a last
        # bit of difference would pick another point of a near-tie
        d = sorted_pos - sorted_centroid
        d2 = d[:, 0] * d[:, 0]
        for a in range(1, d.shape[1]):
            d2 = d2 + d[:, a] * d[:, a]
        d2 = torch.where(sv, d2, torch.full_like(d2, float("inf")))
        seg_min = _segment_min(d2, seg_id, n, float("inf"))
        is_min = d2 <= seg_min[seg_id]
        iota = torch.arange(n, device=positions.device)
        first_min_rank = _segment_min(
            torch.where(is_min, iota, torch.full_like(iota, n)), seg_id, n, n)
        keep_sorted = (iota == first_min_rank[seg_id]) & sv
    return _scatter_back(order, keep_sorted), _scatter_back(order,
                                                            sorted_centroid)


def _octree_select(positions, mask, voxel_size, method, prio15, leaf_keys,
                   K: int, max_levels: int):
    """lpm's octree leaf selection for ``maxPointByNode`` = K > 1.

    One Morton-order sort groups every ancestor cell contiguously; for each
    level l (cell edge = voxel * 2^l, ABSOLUTE alignment, so that the
    hierarchy does not depend on the cloud's extent) segment runs give each
    point its ancestor's count; the leaf of a point is its coarsest
    ancestor holding <= K points (at most ``max_levels`` levels up; level 0
    is the ``maxSizeByNode`` floor).  One representative per leaf, sampled
    per ``method``.

    The voxel coordinates are NOT rebased to the cloud's minimum: a rebase
    by anything but a multiple of 2^L would split ancestor cells.  The sort
    key is ``invalid<<60 | morton<<15 | prio15`` in one int64, the order of
    the two-key int32 sort of lpm's TPU port.  Morton codes take the low 15
    bits of each coordinate; cells whose codes collide after wrapping are
    still told apart below, where runs compare the true shifted coords, so
    a collision can only under-merge.
    """
    n, dim = positions.shape
    dev = positions.device
    L = max(0, min(int(max_levels), 14))
    vc = voxel_coords(positions, voxel_size)  # i32[N, D]
    rel = (vc & 32767).to(torch.int64)
    # interleave: bit l of axis a goes to bit 3 l + (2 - a), x highest
    lv = torch.arange(15, dtype=torch.int64, device=dev)
    shift = 3 * lv[None, :] + (2 - torch.arange(dim, device=dev))[:, None]
    morton = (((rel[:, :, None] >> lv) & 1) << shift).sum(dim=(1, 2))
    key = ((~mask).to(torch.int64) << 60) | (morton << 15) \
        | _prio(method, prio15, n, dev)
    order = torch.sort(key, stable=True).indices

    svc = vc[order]  # TRUE coords, sorted
    sv = mask[order]
    iota = torch.arange(n, dtype=torch.int64, device=dev)

    # runs of equal ancestors at every level at once: [L + 1, N]
    levels = torch.arange(L + 1, dtype=torch.int32, device=dev)
    pre = svc[None] >> levels[:, None, None]
    same = torch.all(pre[:, 1:] == pre[:, :-1], dim=2) & sv[1:] & sv[:-1]
    edge = torch.ones((L + 1, 1), dtype=torch.bool, device=dev)
    is_first = torch.cat([edge, ~same], dim=1)
    is_last = torch.cat([~same, edge], dim=1)
    zero = torch.zeros_like(iota)
    starts = torch.cummax(torch.where(is_first, iota, zero), dim=1).values
    end = torch.flip(torch.cummin(torch.flip(
        torch.where(is_last, iota, torch.full_like(iota, n - 1)), [1]),
        dim=1).values, [1])
    counts = end - starts + 1

    # leaf level: the coarsest ancestor with count <= K (counts do not
    # decrease with the level, so it is a prefix count); level 0 the floor
    lev = (counts[1:] <= K).to(torch.int64).sum(dim=0)
    start_at_lev = torch.gather(starts, 0, lev[None])[0]
    is_first_leaf = sv & (iota == start_at_lev)

    if method == 0:
        return _scatter_back(order, is_first_leaf), positions

    if method == 1:
        # a uniformly random representative over the WHOLE leaf: the sort
        # key's random tie-break only randomises within one base voxel.
        # The leaf's start index is a segment id shared by all its members,
        # so a segment minimum of fresh random keys picks uniformly among
        # the leaf's valid points.
        if leaf_keys is None:
            raise ValueError("voxel_select method 1 with maxPointByNode > 1 "
                             "needs leaf_keys draws")
        big = 1 << 30
        u = torch.where(sv, leaf_keys.to(device=dev, dtype=torch.int64),
                        torch.full_like(iota, big))
        seg = start_at_lev
        leaf_min = _segment_min(u, seg, n, big)
        is_min = sv & (u <= leaf_min[seg])
        first_rank = _segment_min(
            torch.where(is_min, iota, torch.full_like(iota, n)), seg, n, n)
        chosen = sv & (iota == first_rank[seg])
        return _scatter_back(order, chosen), positions

    seg_id = torch.clamp(
        torch.cumsum(is_first_leaf.to(torch.int64), 0) - 1, min=0)
    return _centroid_select(positions, order, sv, is_first_leaf, seg_id,
                            method)
