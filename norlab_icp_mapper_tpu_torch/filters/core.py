"""DataPointsFilters as vectorized masked passes over PointBatch.

Each filter mirrors a libpointmatcher filter, registered under the JAX
package's name and parameters so that one YAML configures both packages:
BoundingBox, DistanceLimit, AddDescriptor, SurfaceNormal (radius and k-NN
engines), CutAtDescriptorThreshold, RandomSampling, MaxPointCount,
OrientNormals, OctreeGrid, ObservationDirection, MaxDist, MinDist, Shadow,
VoxelGrid, Identity, RemoveNaN.  A filter is a function
``apply(batch, draws) -> batch`` that edits masks and descriptors (and, for
the centroid samplings, positions); shapes never change.  ``draws`` is a
:class:`~norlab_icp_mapper_tpu_torch.draws.DrawSource`; only filters that
draw random numbers use it.

A filter is ``ROW_LOCAL`` where a row's output bit depends only on that row
and its own draw and it moves no point (BoundingBox, DistanceLimit, MaxDist,
MinDist, RemoveNaN, Identity, RandomSampling).  A chain of such filters can
run on a reading in another row order than its draws' --
``_apply_impl(batch, draws, rows)``, ``rows[j]`` the original row of row
``j`` -- which is how the ICP solve runs its step chain on the sorted
reading without permuting it back.

Constants reach the card as fills or pinned non-blocking copies
(``draws.upload``), never as pageable copies: a chain of these filters makes
no blocking host read.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..draws import (DrawSource, SITE_OCTREE_PRIO, SITE_RANDOM_SAMPLING,
                     upload)
from ..points import PointBatch
from ..registry import Param, ParametrizedPlugin, Registry
from ..ops.eigen import sym_eig3_smallest, sym_eig2_smallest
from ..ops.voxel import voxel_select
from ..utils.tracing import record_overflow

filter_registry = Registry("DataPointsFilter")


class DataPointsFilter(ParametrizedPlugin):
    # a row's bit depends on that row and its own draw alone, and no point
    # moves: the filter accepts `rows` (see FilterChain._apply_impl)
    ROW_LOCAL = False

    def apply(self, batch: PointBatch,
              draws: Optional[DrawSource] = None) -> PointBatch:
        raise NotImplementedError


class FilterChain:
    """Ordered filter pipeline (reference ``DataPointsFilters`` /
    ``.apply(...)``)."""

    def __init__(self, filters=None):
        self.filters = list(filters or [])

    @staticmethod
    def from_yaml(node) -> "FilterChain":
        if node is None:
            return FilterChain([])
        if not isinstance(node, list):
            raise ValueError("filter chain config must be a YAML list")
        return FilterChain(
            [filter_registry.create_from_yaml_entry(e) for e in node])

    def apply(self, batch: PointBatch,
              draws: Optional[DrawSource] = None) -> PointBatch:
        if not self.filters:
            return batch
        return self._apply_impl(batch, draws)

    @property
    def row_local(self) -> bool:
        """Every filter of the chain is ``ROW_LOCAL``."""
        return all(f.ROW_LOCAL for f in self.filters)

    def _apply_impl(self, batch: PointBatch,
                    draws: Optional[DrawSource] = None,
                    rows: Optional[torch.Tensor] = None) -> PointBatch:
        """The chain on ``batch``; with ``rows`` (int64, row ``j`` of the
        batch is original row ``rows[j]``) every draw lands on its original
        row.  Only a row-local chain takes ``rows``."""
        # a drawing filter asks `draws` for exactly one draw per call
        for f in self.filters:
            if rows is None:
                batch = f.apply(batch, draws)
            elif f.ROW_LOCAL:
                batch = f.apply(batch, draws, rows)
            else:
                raise ValueError(
                    f"{f.NAME} is not row-local: it runs only on the "
                    "reading in its original row order (rows=None)")
        return batch

    def __len__(self):
        return len(self.filters)


@filter_registry.register
class BoundingBoxFilter(DataPointsFilter):
    """Remove (or keep only) points inside an axis-aligned box.

    Mirrors lpm ``BoundingBoxDataPointsFilter`` as used in
    ``examples/config.yaml`` (robot-body cropping)."""

    NAME = "BoundingBoxDataPointsFilter"
    PARAMS = {
        "xMin": Param("inferior x", -1.0), "xMax": Param("superior x", 1.0),
        "yMin": Param("inferior y", -1.0), "yMax": Param("superior y", 1.0),
        "zMin": Param("inferior z", -1.0), "zMax": Param("superior z", 1.0),
        "removeInside": Param("1: remove inside box, 0: keep only inside", 1.0,
                              float, 0, 1),
    }

    ROW_LOCAL = True

    def apply(self, batch, draws=None, rows=None):
        p = self.params
        pos = batch.positions
        lo = upload([p["xMin"], p["yMin"], p["zMin"]][: batch.dim],
                    pos.device)
        hi = upload([p["xMax"], p["yMax"], p["zMax"]][: batch.dim],
                    pos.device)
        inside = torch.all((pos >= lo) & (pos <= hi), dim=1)
        keep = ~inside if p["removeInside"] >= 0.5 else inside
        return batch.with_mask(keep)


@filter_registry.register
class DistanceLimitFilter(DataPointsFilter):
    """Range gate on a coordinate or radial distance.

    The mapper builds one with ``dim=-1, dist=sensorMaxRange,
    removeInside=0`` as its always-on radius filter."""

    NAME = "DistanceLimitDataPointsFilter"
    PARAMS = {
        "dim": Param("-1 = radial norm, 0/1/2 = axis", -1.0, float, -1, 2),
        "dist": Param("distance threshold (m); sign selects side for axis mode",
                      1.0),
        "removeInside": Param("1: remove closer than dist, 0: remove farther",
                              1.0, float, 0, 1),
    }

    ROW_LOCAL = True

    def apply(self, batch, draws=None, rows=None):
        p = self.params
        dim = int(p["dim"])
        dist = float(p["dist"])
        if dim == -1:
            val = torch.linalg.norm(batch.positions, dim=1)
            thr = abs(dist)
        else:
            val = batch.positions[:, dim]
            thr = dist
        inside = val < thr
        keep = ~inside if p["removeInside"] >= 0.5 else inside
        return batch.with_mask(keep)


@filter_registry.register
class AddDescriptorFilter(DataPointsFilter):
    """Attach a constant-valued descriptor to every point.

    Mirrors lpm ``AddDescriptorDataPointsFilter`` (``examples/config.yaml``
    seeds ``probabilityDynamic`` = 0.6 with it)."""

    NAME = "AddDescriptorDataPointsFilter"
    PARAMS = {
        "descriptorName": Param("name of new descriptor", "", str),
        "descriptorDimension": Param("rows of new descriptor", 1.0, float, 1),
        "descriptorValues": Param("constant values (list)", None, list),
    }

    def __init__(self, params=None):
        params = dict(params or {})
        vals = params.get("descriptorValues")
        if isinstance(vals, str):
            params["descriptorValues"] = [
                float(v) for v in vals.strip("[]").split(",")]
        super().__init__(params)
        k = int(self.params["descriptorDimension"])
        if len(self.params["descriptorValues"]) != k:
            raise ValueError(
                f"{self.NAME}: descriptorValues length "
                f"{len(self.params['descriptorValues'])} != descriptorDimension {k}")

    def apply(self, batch, draws=None):
        vals = upload(self.params["descriptorValues"], batch.device)
        v = vals[None, :].expand(batch.capacity, vals.shape[0]).contiguous()
        return batch.with_descriptor(self.params["descriptorName"], v)


@filter_registry.register
class CutAtDescriptorThresholdFilter(DataPointsFilter):
    """Drop points whose named descriptor passes a threshold.

    The bundled configs use it to delete dynamic points after the Bayesian
    update."""

    NAME = "CutAtDescriptorThresholdDataPointsFilter"
    PARAMS = {
        "descName": Param("descriptor to test", "", str),
        "useLargerThan": Param("1: cut points with desc > threshold; 0: <",
                               1.0, float, 0, 1),
        "threshold": Param("threshold value", 0.0),
    }

    def apply(self, batch, draws=None):
        name = self.params["descName"]
        if name not in batch.descriptors:
            raise ValueError(f"{self.NAME}: missing descriptor '{name}'")
        v = batch.descriptors[name][:, 0]
        # compare in f32, like the descriptor
        thr = torch.full((), self.params["threshold"], dtype=torch.float32,
                         device=v.device)
        cut = v > thr if self.params["useLargerThan"] >= 0.5 else v < thr
        return batch.with_mask(~cut)


@filter_registry.register
class RandomSamplingFilter(DataPointsFilter):
    """Keep each point independently with probability ``prob``
    (lpm ``RandomSamplingDataPointsFilter``).

    Draws one uniform per slot from ``draws`` (site
    ``SITE_RANDOM_SAMPLING``, through ``draws.keep``; with ``rows`` slot
    ``j`` takes the draw of original slot ``rows[j]``); without a ``draws``
    argument it seeds a generator of its own from ``seed``."""

    NAME = "RandomSamplingDataPointsFilter"
    PARAMS = {
        "prob": Param("probability to keep each point", 0.75, float, 0, 1),
        "randomSamplingMethod": Param("0: direct RNG (only mode supported)",
                                      0.0, float, 0, 1),
        "seed": Param("generator seed used when no draws are provided", 1.0,
                      float, 0),
    }

    ROW_LOCAL = True

    def apply(self, batch, draws=None, rows=None):
        if draws is None:
            draws = DrawSource(int(self.params["seed"]), batch.device)
        # the keep mask holds batch.mask already: no `&` after it
        return batch.replace(mask=draws.keep(
            SITE_RANDOM_SAMPLING, self.params["prob"], batch.mask, rows))


@filter_registry.register
class SurfaceNormalFilter(DataPointsFilter):
    """Per-point normals (and optional densities) from local PCA.

    Mirrors lpm ``SurfaceNormalDataPointsFilter``: neighborhood covariance
    eigen-decomposition, normal = eigenvector of the smallest eigenvalue.

    - ``maxDist`` finite: **radius PCA** (``ops/pca.py``) -- moments of ALL
      neighbors within ``maxDist``; no top-k.  This diverges from lpm (which
      fits the k nearest within maxDist): on a decimated map both see the
      same local surface.  ``knn`` still acts as the minimum neighbor count
      below which the neighborhood is treated as degenerate.
    - ``maxDist`` = inf: exact k-NN PCA (lpm semantics): the cloud searched
      against itself by brute force (``ops/nn.py``), moments of the k
      neighbours, one closed-form eigensolve.
    """

    NAME = "SurfaceNormalDataPointsFilter"
    PARAMS = {
        "knn": Param("neighbors for PCA", 5.0, float, 3),
        "maxDist": Param("max neighbor distance (inf = unbounded)",
                         float("inf"), float, 0),
        "epsilon": Param("kd-tree approximation bound (ignored: exact NN)",
                         0.0, float, 0),
        "keepNormals": Param("add 'normals' descriptor", 1.0, float, 0, 1),
        "keepDensities": Param("add 'densities' descriptor", 0.0, float, 0, 1),
        "keepEigenValues": Param("add 'eigValues' descriptor", 0.0, float, 0, 1),
        "smoothInfo": Param("unsupported lpm option (must stay 0)", 0.0,
                            float, 0, 0),
        "sortEigen": Param("sort eigenvalues ascending (always the case)",
                           0.0, float, 0, 1),
    }

    # number of (overflow) tiles reported by the last radius pass, 0-d tensor
    last_overflow: Optional[torch.Tensor] = None

    def apply(self, batch, draws=None):
        k = int(self.params["knn"])
        max_dist = self.params["maxDist"]
        if max_dist != float("inf"):
            return self._apply_radius_pca(batch, k, float(max_dist))
        from ..ops.nn import knn
        pos = batch.positions
        d2, idx = knn(pos, pos, batch.mask, batch.mask, k=k)
        neigh = pos[torch.clamp(idx, min=0)]  # [N, k, D]
        # fewer than k valid points leave the tail of a row at -1
        w = (idx >= 0).to(torch.float32)[..., None]  # [N, k, 1]
        cnt = torch.clamp(w.sum(dim=1), min=1.0)  # [N, 1]
        mean = (neigh * w).sum(dim=1) / cnt
        centered = (neigh - mean[:, None, :]) * w
        cov = torch.einsum("nkd,nke->nde", centered, centered) / cnt[..., None]
        if batch.dim == 3:
            evals, normals = sym_eig3_smallest(cov)
        else:
            evals, normals = sym_eig2_smallest(cov)
        out = batch
        if self.params["keepNormals"] >= 0.5:
            out = out.with_descriptor("normals", normals)
        if self.params["keepDensities"] >= 0.5:
            # lpm: density = knn / volume of the knn-ball
            r = torch.sqrt(torch.where(idx >= 0, d2, torch.zeros_like(d2))
                           .amax(dim=1))
            vol = 4.0 / 3.0 * math.pi * torch.clamp(r, min=1e-6) ** 3
            out = out.with_descriptor("densities", (cnt[:, 0] / vol)[:, None])
        if self.params["keepEigenValues"] >= 0.5:
            out = out.with_descriptor("eigValues", evals)
        return out

    def _apply_radius_pca(self, batch, k, max_dist):
        from ..ops.pca import radius_pca_normals
        # sweep window scales with the radius: a q_tile of sorted queries
        # plus 2r of refs must fit in W (pair work is N*W, so don't pay a
        # 2 m-sized window for sub-metre neighborhoods).
        # Degenerate neighborhoods (< knn points in radius, lpm's k as the
        # minimum sample count) keep a unit normal along the last axis
        # rather than noise from a rank-deficient covariance: min_count.
        # On the card this is a sort, a pack and one kernel launch.
        W = 2048 if max_dist <= 1.0 else 4096
        cnt, evals, normals, overflow = radius_pca_normals(
            batch.positions, batch.positions, batch.mask, batch.mask,
            max_radius=max_dist, q_tile=1024, W=W, min_count=min(k, 3))
        self.last_overflow = overflow
        record_overflow("surface_normal_sweep", overflow)
        out = batch
        if self.params["keepNormals"] >= 0.5:
            out = out.with_descriptor("normals", normals)
        if self.params["keepDensities"] >= 0.5:
            if batch.dim == 3:
                vol = 4.0 / 3.0 * math.pi * max_dist ** 3
            else:
                vol = math.pi * max_dist ** 2
            out = out.with_descriptor("densities", (cnt / vol)[:, None])
        if self.params["keepEigenValues"] >= 0.5:
            out = out.with_descriptor("eigValues", evals)
        return out


@filter_registry.register
class MaxPointCountFilter(DataPointsFilter):
    """Keep at most ``maxCount`` points (first ones, in order) --
    lpm ``MaxPointCountDataPointsFilter``."""

    NAME = "MaxPointCountDataPointsFilter"
    PARAMS = {
        "maxCount": Param("maximum number of points", 1000.0, float, 0),
        "seed": Param("unused (kept for lpm param parity)", 1.0, float, 0),
    }

    def apply(self, batch, draws=None):
        rank = torch.cumsum(batch.mask.to(torch.int64), 0) - 1
        return batch.with_mask(rank < int(self.params["maxCount"]))


@filter_registry.register
class OrientNormalsFilter(DataPointsFilter):
    """Flip normals toward (or away from) the sensor origin
    (lpm ``OrientNormalsDataPointsFilter``; assumes cloud in sensor frame)."""

    NAME = "OrientNormalsDataPointsFilter"
    PARAMS = {
        "towardCenter": Param("1: orient toward origin", 1.0, float, 0, 1),
    }

    def apply(self, batch, draws=None):
        if "normals" not in batch.descriptors:
            raise ValueError(f"{self.NAME}: cloud has no 'normals' descriptor")
        n = batch.descriptors["normals"]
        dot = torch.sum(n * batch.positions, dim=1, keepdim=True)
        flip = dot > 0 if self.params["towardCenter"] >= 0.5 else dot < 0
        return batch.with_descriptor("normals", torch.where(flip, -n, n))


def _decimate(batch, vox, method, draws):
    """One representative per voxel (``ops/voxel.py``); method 2 moves it to
    the voxel's centroid."""
    prio = None
    if method == 1:
        if draws is None:
            draws = DrawSource(0, batch.device)
        prio = draws.prio15(SITE_OCTREE_PRIO, batch.capacity)
    keep, centroid = voxel_select(batch.positions, batch.mask, vox,
                                  method=method, prio15=prio)
    out = batch.with_mask(keep)
    if method == 2:
        out = out.replace(positions=torch.where(keep[:, None], centroid,
                                                out.positions))
    return out


@filter_registry.register
class OctreeGridFilter(DataPointsFilter):
    """Spatial decimation to one representative per voxel.

    The counterpart of lpm ``OctreeGridDataPointsFilter``: lpm subdivides an
    octree until leaves are below ``maxSizeByNode``; here a uniform voxel
    grid of that edge length gives the same decimation density with a sort
    and a segment pass.  ``samplingMethod``: 0 = first point, 1 = random
    (draws ``SITE_OCTREE_PRIO``), 2 = centroid, 3 = medoid.  As in the JAX
    package, ``maxPointByNode`` is accepted and not applied here (the
    OctreeMapperModule applies it).
    """

    NAME = "OctreeGridDataPointsFilter"
    PARAMS = {
        "buildParallel": Param("lpm threading flag (no-op here)",
                               1.0, float, 0, 1),
        "maxPointByNode": Param("stop subdividing below this many points "
                                "(approximated: voxel size only)", 1.0, float, 1),
        "maxSizeByNode": Param("leaf/voxel edge length (m); 0 disables",
                               0.0, float, 0),
        "samplingMethod": Param("0 first, 1 random, 2 centroid, 3 medoid",
                                0.0, float, 0, 3),
    }

    def apply(self, batch, draws=None):
        vox = self.params["maxSizeByNode"]
        if vox <= 0.0:
            return batch
        return _decimate(batch, vox, int(self.params["samplingMethod"]),
                         draws)


@filter_registry.register
class ObservationDirectionFilter(DataPointsFilter):
    """Add unit vectors from each point toward the sensor
    (lpm ``ObservationDirectionDataPointsFilter``; cloud in sensor frame).
    The descriptor rotates covariantly under SE(3) like normals."""

    NAME = "ObservationDirectionDataPointsFilter"
    PARAMS = {
        "x": Param("sensor x in scan frame", 0.0),
        "y": Param("sensor y in scan frame", 0.0),
        "z": Param("sensor z in scan frame", 0.0),
    }

    def apply(self, batch, draws=None):
        p = self.params
        origin = upload([p["x"], p["y"], p["z"]][: batch.dim], batch.device)
        v = origin[None, :] - batch.positions
        n = torch.clamp(torch.linalg.norm(v, dim=1, keepdim=True), min=1e-12)
        return batch.with_descriptor("observationDirections", v / n)


def _axis_value(batch, dim):
    if dim == -1:
        return torch.linalg.norm(batch.positions, dim=1)
    return batch.positions[:, dim]


@filter_registry.register
class MaxDistFilter(DataPointsFilter):
    """Keep points closer than ``maxDist`` (lpm ``MaxDistDataPointsFilter``)."""

    NAME = "MaxDistDataPointsFilter"
    PARAMS = {
        "dim": Param("-1 = radial norm, 0/1/2 = axis", -1.0, float, -1, 2),
        "maxDist": Param("distance threshold (m)", 1.0),
    }

    ROW_LOCAL = True

    def apply(self, batch, draws=None, rows=None):
        val = _axis_value(batch, int(self.params["dim"]))
        return batch.with_mask(val < float(np.float32(self.params["maxDist"])))


@filter_registry.register
class MinDistFilter(DataPointsFilter):
    """Keep points farther than ``minDist`` (lpm ``MinDistDataPointsFilter``)."""

    NAME = "MinDistDataPointsFilter"
    PARAMS = {
        "dim": Param("-1 = radial norm, 0/1/2 = axis", -1.0, float, -1, 2),
        "minDist": Param("distance threshold (m)", 1.0),
    }

    ROW_LOCAL = True

    def apply(self, batch, draws=None, rows=None):
        val = _axis_value(batch, int(self.params["dim"]))
        return batch.with_mask(val > float(np.float32(self.params["minDist"])))


@filter_registry.register
class ShadowFilter(DataPointsFilter):
    """Remove shadow points -- points whose normal is nearly orthogonal to
    the viewing ray (lpm ``ShadowDataPointsFilter``; needs ``normals``,
    cloud in sensor frame)."""

    NAME = "ShadowDataPointsFilter"
    PARAMS = {
        "eps": Param("cos-angle threshold below which a point is shadow",
                     0.1, float, 0, 1),
    }

    def apply(self, batch, draws=None):
        if "normals" not in batch.descriptors:
            raise ValueError(f"{self.NAME}: cloud has no 'normals' descriptor")
        pdir = batch.positions / torch.clamp(
            torch.linalg.norm(batch.positions, dim=1, keepdim=True),
            min=1e-12)
        cosang = torch.abs(torch.sum(batch.descriptors["normals"] * pdir,
                                     dim=1))
        return batch.with_mask(cosang > float(np.float32(self.params["eps"])))


@filter_registry.register
class VoxelGridFilter(DataPointsFilter):
    """Centroid-per-voxel downsampling (lpm ``VoxelGridDataPointsFilter``)."""

    NAME = "VoxelGridDataPointsFilter"
    PARAMS = {
        "vSizeX": Param("voxel edge x (m)", 0.2, float, 0),
        "vSizeY": Param("voxel edge y (m) (must equal vSizeX here)", 0.2,
                        float, 0),
        "vSizeZ": Param("voxel edge z (m) (must equal vSizeX here)", 0.2,
                        float, 0),
        "useCentroid": Param("1: centroid, 0: first point", 1.0, float, 0, 1),
    }

    def apply(self, batch, draws=None):
        method = 2 if self.params["useCentroid"] >= 0.5 else 0
        return _decimate(batch, self.params["vSizeX"], method, draws)


@filter_registry.register
class IdentityFilter(DataPointsFilter):
    """No-op filter (lpm ``IdentityDataPointsFilter``)."""

    NAME = "IdentityDataPointsFilter"
    PARAMS = {}

    ROW_LOCAL = True

    def apply(self, batch, draws=None, rows=None):
        return batch


@filter_registry.register
class RemoveNaNFilter(DataPointsFilter):
    """Drop points with non-finite coordinates
    (lpm ``RemoveNaNDataPointsFilter``)."""

    NAME = "RemoveNaNDataPointsFilter"
    PARAMS = {}

    ROW_LOCAL = True

    def apply(self, batch, draws=None, rows=None):
        return batch.with_mask(torch.all(torch.isfinite(batch.positions),
                                         dim=1))
