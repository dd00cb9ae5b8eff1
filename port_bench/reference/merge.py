"""Plain map merge of one registered scan, the MapperModules and post
filters the two configurations name:

* ``dynamic_probabilities``: DynamicPointsMapperModule (Pomerleau et al.
  2014, ``DynamicPointsMapperModule.cpp``), each map point's
  ``probabilityDynamic`` after the scan;
* ``voxel_keys`` / ``octree_merge``: OctreeMapperModule with
  ``samplingMethod: 1`` on a grid of ``maxSizeByNode`` cells (one point per
  cell of the union of map and scan, drawn at random), then
  SurfaceNormal (``radius_normals``) and CutAtDescriptorThreshold;
* ``point_distance_new``: PointDistanceMapperModule, the scan points at
  least ``minDistNewPoint`` from every map point.
"""
from __future__ import annotations

import torch

from .icp import transform
from .nn import knn
from .normals import radius_normals

EPS = 1e-4  # the module's own constant


def _angles(p: torch.Tensor) -> torch.Tensor:
    r = torch.linalg.norm(p, dim=1)
    az = torch.atan2(p[:, 1], p[:, 0])
    el = torch.asin(torch.clamp(p[:, 2] / r.clamp(min=1e-12), -1, 1))
    return torch.stack([az, el], 1)


def dynamic_probabilities(scan_s: torch.Tensor, map_pos: torch.Tensor,
                          map_normals: torch.Tensor, prob: torch.Tensor,
                          pose: torch.Tensor, p: dict) -> torch.Tensor:
    """``probabilityDynamic`` f32[M] of the map points after the scan
    (``scan_s`` in the sensor frame, the map in the map frame, ``pose`` the
    scan's corrected pose)."""
    inv = torch.linalg.inv(pose.double()).float()
    map_s = transform(inv, map_pos)
    normals_s = map_normals @ inv[:3, :3].T
    scan_r = torch.linalg.norm(scan_s, dim=1)
    map_r = torch.linalg.norm(map_s, dim=1)
    in_range = map_r < p["sensorMaxRange"]
    half = p["beamHalfAngle"]
    d2, idx = knn(_angles(map_s), _angles(scan_s), 1, 2.0 * half)
    d2, idx = d2[:, 0], idx[:, 0]
    has = idx >= 0
    j = idx.clamp(min=0)
    ip_norm = scan_r[j]
    delta = torch.linalg.norm(scan_s[j] - map_s, dim=1)
    d_max = p["epsilonA"] * ip_norm
    lp_dir = map_s / map_r.clamp(min=1e-12)[:, None]
    w_v = EPS + (1 - EPS) * torch.abs((normals_s * lp_dir).sum(1))
    w_d1 = EPS + (1 - EPS) * (
        1 - torch.sqrt(torch.where(has, d2, torch.zeros_like(d2))) / (2 * half))
    off = delta - p["epsilonD"]
    dm = d_max.clamp(min=1e-12)
    one = torch.ones_like(delta)
    w_d2 = torch.where((delta < p["epsilonD"]) | (map_r > ip_norm), EPS * one,
                       torch.where(off < d_max, EPS + (1 - EPS) * off / dm,
                                   one))
    w_p2 = torch.where(delta < p["epsilonD"], one,
                       torch.where(off < d_max,
                                   EPS + (1 - EPS) * (1 - off / dm),
                                   EPS * one))
    a, b = p["alpha"], p["beta"]
    c1, c2 = 1 - w_v * w_d1, w_v * w_d1
    below = prob < p["thresholdDynamic"]
    p_dyn = torch.where(below, c1 * prob + c2 * w_d2 * ((1 - a) * (1 - prob)
                                                        + b * prob),
                        (1 - EPS) * one)
    p_stat = torch.where(below, c1 * (1 - prob) + c2 * w_p2 * (
        a * (1 - prob) + (1 - b) * prob), EPS * one)
    new = p_dyn / (p_dyn + p_stat).clamp(min=1e-12)
    visible = (ip_norm + p["epsilonD"] + d_max) >= map_r
    return torch.where(has & visible & in_range, new, prob)


def voxel_keys(points: torch.Tensor, size: float) -> torch.Tensor:
    """One int64 key per point: its cell of a grid of ``size`` from the
    origin."""
    c = torch.floor(points / size).to(torch.int64) + (1 << 20)
    return (c[:, 0] << 42) | (c[:, 1] << 21) | c[:, 2]


def octree_merge(map_pos, map_normals, map_prob, scan_s, pose, modules,
                 post, generator):
    """The map after one scan: ``(positions, normals, prob)``."""
    dyn = modules["DynamicPointsMapperModule"]
    size = modules["OctreeMapperModule"]["maxSizeByNode"]
    prob = dynamic_probabilities(scan_s, map_pos, map_normals, map_prob,
                                 pose, dyn) if map_pos.shape[0] else map_prob
    scan_m = transform(pose, scan_s)
    pos = torch.cat([map_pos, scan_m])
    prob = torch.cat([prob, torch.full((scan_m.shape[0],), post["initial"],
                                       device=pos.device)])
    _, cell = torch.unique(voxel_keys(pos, size), return_inverse=True)
    prio = torch.rand(pos.shape[0], generator=generator, device=pos.device)
    best = torch.full((int(cell.max()) + 1,), 2.0, device=pos.device)
    best = best.scatter_reduce(0, cell, prio, reduce="amin")
    keep = prio == best[cell]
    pos, prob = pos[keep], prob[keep]
    normals = radius_normals(pos, post["maxDist"], post["minCount"])
    kept = ~(prob > post["threshold"])
    return pos[kept], normals[kept], prob[kept]


def point_distance_new(map_pos: torch.Tensor, scan_m: torch.Tensor,
                       min_dist: float) -> torch.Tensor:
    """bool[S]: the scan points (map frame) that the module adds."""
    if map_pos.shape[0] == 0:
        return torch.ones(scan_m.shape[0], dtype=torch.bool,
                          device=scan_m.device)
    d2, _ = knn(scan_m, map_pos, 1)
    return ~(d2[:, 0] < min_dist * min_dist)


def angle_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Unsigned angle (rad) between unit normals, sign ignored."""
    c = torch.abs((a * b).sum(1)).clamp(max=1.0)
    return torch.arccos(c)

