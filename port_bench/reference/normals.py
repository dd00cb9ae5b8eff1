"""Plain surface normals: the eigenvector of the smallest eigenvalue of the
covariance of a point's neighbourhood, as libpointmatcher's
SurfaceNormalDataPointsFilter defines it.

* ``radius_normals``: every neighbour within ``radius`` (the mapper's
  SurfaceNormal filter with a finite ``maxDist``); fewer than ``min_count``
  neighbours give the unit normal along the last axis.
* ``knn_normals``: the ``k`` nearest neighbours, the point itself among
  them (the filter with an unbounded ``maxDist``).

Each neighbourhood is centred on its own point before its moments are
summed, so no moment carries the map's coordinates' magnitude.
"""
from __future__ import annotations

import torch

from .nn import knn, radius_neighbours


EIGH_BATCH = 16384  # matrices per batched eigensolve call


def _smallest_eigvec(cov: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.linalg.eigh(c).eigenvectors[..., :, 0]
                      for c in cov.split(EIGH_BATCH)])


def _moments_normal(rel: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``rel`` f32[B, K, D] neighbours minus their query, ``w`` f32[B, K]
    the neighbour weights (0 or 1)."""
    cnt = w.sum(1).clamp(min=1.0)
    mean = (rel * w[..., None]).sum(1) / cnt[:, None]
    c = (rel - mean[:, None, :]) * w[..., None]
    cov = (c[:, :, :, None] * c[:, :, None, :]).sum(1) / cnt[:, None, None]
    return _smallest_eigvec(cov)


def radius_normals(points: torch.Tensor, radius: float,
                   min_count: int) -> torch.Tensor:
    """f32[N, D] unit normals of ``points`` (valid rows only)."""
    out = torch.zeros_like(points)
    for rows, idx, inside in radius_neighbours(points, radius):
        rel = points[idx] - points[rows][:, None, :]
        n = _moments_normal(rel, inside.to(points.dtype))
        few = inside.sum(1) < min_count
        axis = torch.zeros_like(n)
        axis[:, -1] = 1.0
        out[rows] = torch.where(few[:, None], axis, n)
    return out


def knn_normals(points: torch.Tensor, k: int) -> torch.Tensor:
    """f32[N, D] unit normals of ``points`` from their ``k`` nearest."""
    _, idx = knn(points, points, k)
    w = (idx >= 0).to(points.dtype)
    rel = points[idx.clamp(min=0)] - points[:, None, :]
    return _moments_normal(rel, w)
