"""MapperModules: the scan-merge pipeline plugins, as vectorized passes.

Parity with the reference's three modules:

  - PointDistanceMapperModule -- map dedup by 1-NN distance gate
  - OctreeMapperModule        -- concatenate + octree/voxel decimation
  - DynamicPointsMapperModule -- Bayesian dynamic-point probability update

The reference API is ``createMap(input, pose)`` (first scan) and
``updateMap(input, map, pose)``; both are functional here: PointBatch in,
PointBatch out, fixed capacities, mask-only deletions.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import se3
from ..draws import DrawSource, SITE_OCTREE_LEAF, SITE_OCTREE_PRIO
from ..points import PointBatch, insert
from ..registry import Param, ParametrizedPlugin, Registry
from ..ops.nn import nn1
from ..ops.voxel import voxel_select
from ..utils.tracing import record_overflow

mapper_module_registry = Registry("MapperModule")


class MapperModule(ParametrizedPlugin):
    """Plugin ABC (reference ``MapperModule.h``).

    ``update_map`` is fixed-capacity: output capacity == map capacity.  A
    module that writes scan points into the map (``INSERTS = 1``) needs the
    caller to provide one scan's worth of free-slot headroom; the Map sizes
    the buffer from the sum of ``INSERTS`` over the configured modules.
    """

    INSERTS = 0  # free-slot headroom this module needs, in scans

    def create_map(self, scan: PointBatch, pose: torch.Tensor,
                   draws: Optional[DrawSource] = None) -> PointBatch:
        return scan

    def update_map(self, scan: PointBatch, map_batch: PointBatch,
                   pose: torch.Tensor,
                   draws: Optional[DrawSource] = None) -> PointBatch:
        raise NotImplementedError


@mapper_module_registry.register
class PointDistanceMapperModule(MapperModule):
    """Add only scan points at least ``minDistNewPoint`` from the map.

    Mirrors ``PointDistanceMapperModule.cpp``: 1-NN of each scan point into
    the map (libnabo kd-tree there, the brute-force search of ``ops/nn.py``
    here), keep points with squared distance >= minDistNewPoint^2, insert
    the survivors.  Scan points are tested against the map only, never
    against each other.
    """

    NAME = "PointDistanceMapperModule"
    PARAMS = {
        "minDistNewPoint": Param(
            "Distance from current map points under which a new point "
            "is not added to the map (in meters).", 0.03, float, 0.0),
    }

    # one inserting pass: Map sizes the buffer with one scan of headroom
    INSERTS = 1

    def update_map(self, scan, map_batch, pose, draws=None):
        min_dist = self.params["minDistNewPoint"]
        d2, _ = nn1(scan.positions, map_batch.positions, scan.mask,
                    map_batch.mask)
        # no match (inf) counts as "far" and is kept, as in nabo; the gate
        # is rounded to f32 once, like the distances it is held against
        keep = scan.mask & ~(d2 < float(np.float32(min_dist * min_dist)))
        return insert(map_batch, scan.with_mask(keep))


@mapper_module_registry.register
class OctreeMapperModule(MapperModule):
    """Concatenate scan into map, then decimate (one point per voxel).

    Mirrors ``OctreeMapperModule.cpp`` (concatenate +
    OctreeGridDataPointsFilter in place).  See ``ops/voxel.py`` for why the
    octree is a uniform voxel grid here, and how ``maxPointByNode > 1``
    coarsens it.  ``samplingMethod: 1`` draws ``SITE_OCTREE_PRIO`` and, with
    ``maxPointByNode > 1``, ``SITE_OCTREE_LEAF`` (one draw of each per
    call, over the union's rows).
    """

    NAME = "OctreeMapperModule"
    PARAMS = {
        "buildParallel": Param("lpm threading flag (no-op here)",
                               1.0, float, 0, 1),
        "samplingMethod": Param("0 first, 1 random, 2 centroid, 3 medoid",
                                0.0, float, 0, 3),
        "maxPointByNode": Param(
            "octree leaf point cap: a node subdivides while it holds more "
            "points AND is larger than maxSizeByNode (lpm rule; K>1 "
            "coarsens sparse regions hierarchically)", 1.0, float, 1),
        "maxSizeByNode": Param("leaf/voxel edge length (m)", 0.0, float, 0),
    }

    def _select(self, positions, mask, draws):
        method = int(self.params["samplingMethod"])
        k = int(self.params["maxPointByNode"])
        prio = leaf = None
        if method == 1:
            if draws is None:
                draws = DrawSource(0, positions.device)
            n = positions.shape[0]
            prio = draws.prio15(SITE_OCTREE_PRIO, n)
            if k > 1:
                leaf = draws.int30(SITE_OCTREE_LEAF, n)
        return method, voxel_select(
            positions, mask, self.params["maxSizeByNode"], method=method,
            prio15=prio, max_point_by_node=k, leaf_keys=leaf)

    def _decimate(self, batch: PointBatch,
                  draws: Optional[DrawSource] = None) -> PointBatch:
        if self.params["maxSizeByNode"] <= 0.0:
            return batch
        method, (keep, centroid) = self._select(batch.positions, batch.mask,
                                                draws)
        out = batch.with_mask(keep)
        if method == 2:
            out = out.replace(positions=torch.where(
                keep[:, None], centroid, out.positions))
        return out

    def create_map(self, scan, pose, draws=None):
        # reference inPlaceCreateMap: update with an empty map == decimate scan
        return self._decimate(scan, draws)

    # TRANSIENT insert: the union decimation below needs NO permanent
    # free-slot headroom in the map buffer -- the concatenation lives as a
    # per-merge value, survivors write back in place.  The map buffer only
    # needs room for genuinely NEW voxels.
    INSERTS = 0

    def update_map(self, scan, map_batch, pose, draws=None):
        if self.params["maxSizeByNode"] <= 0.0:
            return insert(map_batch, scan)
        # Decimate the TRANSIENT union [map; scan] instead of physically
        # inserting the scan first.  Union rows keep map-first order, so
        # samplingMethod=0 ("first") picks the same survivors as the
        # reference's concatenate-then-filter; map-row survivors stay in
        # place, scan-row survivors (new voxels) scatter into free slots.
        cat_pos = torch.cat([map_batch.positions, scan.positions])
        cat_mask = torch.cat([map_batch.mask, scan.mask])
        method, (keep, centroid) = self._select(cat_pos, cat_mask, draws)
        cap = map_batch.capacity
        out = map_batch.with_mask(map_batch.mask & keep[:cap])
        new_scan = scan.with_mask(scan.mask & keep[cap:])
        if method == 2:
            out = out.replace(positions=torch.where(
                out.mask[:, None], centroid[:cap], out.positions))
            new_scan = new_scan.replace(positions=torch.where(
                new_scan.mask[:, None], centroid[cap:], new_scan.positions))
        return insert(out, new_scan)


@mapper_module_registry.register
class DynamicPointsMapperModule(MapperModule):
    """Bayesian dynamic-point probability update (Pomerleau et al. 2014).

    Faithful vectorization of ``DynamicPointsMapperModule.cpp``: transform
    scan and map into the sensor frame, convert to spherical coordinates,
    1-NN in (azimuth, elevation) space from each in-range map point into the
    scan beam directions with search radius ``2 * beamHalfAngle`` (Euclidean
    in angle space, exactly like the reference's nabo call -- no azimuth
    wraparound there either), then update the ``probabilityDynamic``
    descriptor with visibility weights w_v, w_d1, w_d2, w_p2.  Points are NOT
    removed here -- deletion is the CutAtDescriptorThreshold post filter.
    """

    NAME = "DynamicPointsMapperModule"
    PARAMS = {
        "thresholdDynamic": Param(
            "Probability at which a point is considered permanently dynamic.",
            0.6, float, 0.0, 1.0),
        "alpha": Param("P(static | was static)", 0.8, float, 0.0, 1.0),
        "beta": Param("P(dynamic | was dynamic)", 0.99, float, 0.0, 1.0),
        "beamHalfAngle": Param("half angle of sensor beam cones (rad)",
                               0.01, float, 0.0, 1.57079632679489661923),
        "epsilonA": Param("error proportional to sensor distance",
                          0.01, float, 0.0),
        "epsilonD": Param("fixed sensor distance error (m)", 0.01, float, 0.0),
        "sensorMaxRange": Param("max laser range (m)", 200.0, float, 0.0),
    }

    # overflow tiles of the last angular sweep, 0-d tensor
    last_overflow: Optional[torch.Tensor] = None

    def update_map(self, scan, map_batch, pose, draws=None):
        if "probabilityDynamic" not in scan.descriptors:
            raise ValueError(
                "Missing field 'probabilityDynamic' in input point cloud. You "
                "can add it with the AddDescriptorDataPointsFilter in your "
                "input filters.")
        if "normals" not in map_batch.descriptors:
            raise ValueError(
                "Missing field 'normals' in map point cloud. You can add it "
                "with the SurfaceNormalDataPointsFilter in your post filters.")
        p = self.params
        new_prob, self.last_overflow = _dynamic_points_update(
            scan.positions, scan.mask,
            map_batch.positions, map_batch.mask,
            map_batch.descriptors["normals"],
            map_batch.descriptors["probabilityDynamic"][:, 0],
            pose,
            p["thresholdDynamic"], p["alpha"], p["beta"],
            p["beamHalfAngle"], p["epsilonA"], p["epsilonD"],
            p["sensorMaxRange"])
        record_overflow("dynamic_points_sweep", self.last_overflow)
        return map_batch.with_descriptor("probabilityDynamic", new_prob)


def _spherical_angles(pts: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """(azimuth, elevation) per point.  The reference stores (elevation,
    azimuth); the Euclidean angular distance is symmetric in the two, and
    leading with azimuth lets the sorted-sweep NN use a tight candidate
    window (azimuth spreads lidar beams uniformly; elevation clusters them
    on rings).  For 2-D clouds elevation is 0."""
    dim = pts.shape[1]
    az = torch.atan2(pts[:, 1], pts[:, 0])
    if dim == 3:
        el = torch.asin(torch.clamp(
            pts[:, 2] / torch.clamp(radii, min=1e-12), -1, 1))
    else:
        el = torch.zeros_like(az)
    return torch.stack([az, el], dim=1)


def _dynamic_points_update(scan_pos, scan_mask, map_pos, map_mask,
                           map_normals, prob_dyn, pose,
                           threshold_dynamic, alpha, beta, beam_half_angle,
                           eps_a, eps_d, sensor_max_range):
    """Returns ``(new probabilityDynamic [M, 1], overflow tiles)``."""
    from ..ops.nn_sweep import sweep_knn
    pose_inv = se3.inverse(pose).to(scan_pos.device)
    scan_s = se3.apply_points(pose_inv, scan_pos)  # sensor frame
    map_s = se3.apply_points(pose_inv, map_pos)
    dim = scan_pos.shape[1]
    R_inv = pose_inv[:dim, :dim]
    normals_s = map_normals @ R_inv.T

    scan_r = torch.linalg.norm(scan_s, dim=1)
    map_r = torch.linalg.norm(map_s, dim=1)
    in_range = map_mask & (map_r < sensor_max_range)

    scan_ang = _spherical_angles(scan_s, scan_r)
    map_ang = _spherical_angles(map_s, map_r)

    # angular 1-NN: map beams -> nearest scan beam, radius 2*beamHalfAngle,
    # through the sweep kernel at D=2.  The sweep sorts by azimuth, where
    # lidar beams spread uniformly: a 1024-query tile spans ~0.1 rad, so
    # W=1024 comfortably covers the candidate span at typical beamHalfAngle
    # (~0.01 rad); overflow is reported if it doesn't.
    radius = 2.0 * beam_half_angle
    d2k, idxk, overflow = sweep_knn(map_ang, scan_ang, in_range, scan_mask,
                                    k=1, max_radius=radius, q_tile=1024,
                                    W=1024)
    d2, idx = d2k[:, 0], idxk[:, 0]
    new_prob = dynamic_points_bayes(
        scan_s, scan_r, map_s, map_r, normals_s, prob_dyn, d2, idx, in_range,
        threshold_dynamic, alpha, beta, beam_half_angle, eps_a, eps_d)
    return new_prob[:, None], overflow


def dynamic_points_bayes(scan_s, scan_r, map_s, map_r, normals_s, prob_dyn,
                         d2, idx, in_range, threshold_dynamic, alpha, beta,
                         beam_half_angle, eps_a, eps_d):
    """The visibility-weight Bayesian update given an already-computed
    angular 1-NN (``d2``/``idx``: squared angular distance and scan index per
    map point, ``idx < 0`` for no match within ``2*beamHalfAngle``).

    All inputs are in the SENSOR frame.  Faithful to
    ``DynamicPointsMapperModule.cpp:82-150``.
    """
    eps = 1e-4  # reference `eps` constant
    has_match = idx >= 0
    sidx = torch.clamp(idx, min=0)

    ip = scan_s[sidx]  # matched scan point, sensor frame [M, D]
    ip_norm = scan_r[sidx]
    lp = map_s
    lp_norm = map_r
    delta = torch.linalg.norm(ip - lp, dim=1)
    d_max = eps_a * ip_norm

    lp_dir = lp / torch.clamp(lp_norm, min=1e-12)[:, None]
    w_v = eps + (1.0 - eps) * torch.abs(torch.sum(normals_s * lp_dir, dim=1))
    w_d1 = eps + (1.0 - eps) * (
        1.0 - torch.sqrt(torch.where(has_match, d2, torch.zeros_like(d2)))
        / (2.0 * beam_half_angle))

    offset = delta - eps_d
    d_max_safe = torch.clamp(d_max, min=1e-12)
    close_or_behind = (delta < eps_d) | (lp_norm > ip_norm)
    full = torch.ones_like(delta)
    w_d2 = torch.where(
        close_or_behind, full * eps,
        torch.where(offset < d_max, eps + (1.0 - eps) * offset / d_max_safe,
                    full))
    w_p2 = torch.where(
        delta < eps_d, full,
        torch.where(offset < d_max,
                    eps + (1.0 - eps) * (1.0 - offset / d_max_safe),
                    full * eps))

    visible = (ip_norm + eps_d + d_max) >= lp_norm
    last_dyn = prob_dyn
    c1 = 1.0 - w_v * w_d1
    c2 = w_v * w_d1
    below = last_dyn < threshold_dynamic
    p_dyn = torch.where(
        below,
        c1 * last_dyn + c2 * w_d2 * ((1.0 - alpha) * (1.0 - last_dyn)
                                     + beta * last_dyn),
        full * (1.0 - eps))
    p_stat = torch.where(
        below,
        c1 * (1.0 - last_dyn) + c2 * w_p2 * (alpha * (1.0 - last_dyn)
                                             + (1.0 - beta) * last_dyn),
        full * eps)
    updated = p_dyn / torch.clamp(p_dyn + p_stat, min=1e-12)
    do_update = has_match & visible & in_range
    return torch.where(do_update, updated, prob_dyn)
