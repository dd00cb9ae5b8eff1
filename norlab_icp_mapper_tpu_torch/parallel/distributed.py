"""Distributed scan-to-map registration over the ranks of a device mesh.

The map's cell blocks are split over the ranks of a mesh axis (``"cells"``),
one block per rank, and scan-to-map alignment runs on every rank with
explicit collectives, as the JAX package's ``shard_map`` code runs on every
device:

  - the (small) reading scan is replicated to every rank,
  - each rank finds the 1-NN of every reading point inside its own block
    (``ops.nn.nn1``: the ``knn_brute`` kernel on the card, its plain version
    on the CPU),
  - an ``all_reduce(MIN)`` over the axis picks the global winner per reading
    point (the ``pmin``), and an ``all_reduce(SUM)`` of the claims splits
    exact ties,
  - each rank accumulates the Gauss-Newton normal equations only for the
    points it won, and one packed ``all_reduce(SUM)`` carries ``JtJ``,
    ``Jtr``, the weight sum and the weighted sum of squares (the
    reference's ``psum``s of the same values),
  - the solve and the SE(3) update are replicated.

Communication per iteration: one f32[N] min, one f32[N] sum and one
f32[dof² + dof + 2] sum.  The loop runs ``max_iter`` iterations and reads
nothing back to the host.  NCCL on the card, gloo on the CPU
(``multihost.initialize``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from .. import se3
from ..draws import resolve_device, upload
from ..ops.nn import nn1, pack_refs
from .multihost import rank_device

__all__ = ["make_mesh", "DistributedICP", "shard_points"]


def make_mesh(n_devices: Optional[int] = None,
              axis: str = "cells") -> DeviceMesh:
    """A one-axis mesh over every rank of the initialised process group
    (``multihost.initialize``): ``"cuda"`` under NCCL, ``"cpu"`` under gloo.
    ``n_devices``, if given, must equal the world size."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "parallel.multihost.initialize() first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"n_devices={n_devices}, but the process group has "
                         f"{world} ranks (one device per rank)")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (world,), mesh_dim_names=(axis,))


def shard_points(positions: np.ndarray, normals: np.ndarray,
                 mask: np.ndarray, n_shards: int, cell_size: float = 20.0):
    """Partition map points into ``n_shards`` equal-capacity spatial shards.

    Points are bucketed by cell row (floor(x / cell_size)) and cells are
    round-robined across shards — the host-side analog of the Map's cell
    grid, keeping each shard's points spatially coherent so its NN search
    stays cheap.  Output arrays have shape [n_shards, cap, ...].
    """
    n = positions.shape[0]
    rows = np.floor(positions[:, 0] / cell_size).astype(np.int64)
    shard_of_point = np.abs(rows) % n_shards
    shard_of_point = np.where(mask, shard_of_point, -1)
    cap = 0
    groups = []
    for s in range(n_shards):
        idx = np.nonzero(shard_of_point == s)[0]
        groups.append(idx)
        cap = max(cap, len(idx))
    cap = max(256, int(2 ** np.ceil(np.log2(max(cap, 1)))))
    D = positions.shape[1]
    out_pos = np.zeros((n_shards, cap, D), np.float32)
    out_nrm = np.zeros((n_shards, cap, D), np.float32)
    out_msk = np.zeros((n_shards, cap), bool)
    for s, idx in enumerate(groups):
        out_pos[s, :len(idx)] = positions[idx]
        out_nrm[s, :len(idx)] = normals[idx]
        out_msk[s, :len(idx)] = True
    return out_pos, out_nrm, out_msk


class DistributedICP:
    """Point-to-plane ICP with the map split over a mesh axis.

    ``solve(reading..., this rank's map block...)`` returns the correction
    transform, like the single-device engine.  The matcher is 1-NN with
    ``max_dist`` gating; convergence is a fixed iteration count (counter
    checker), the common production configuration for scan-to-map with a
    good prior.  ``ref_tile`` is kept for the reference's signature: the
    ``knn_brute`` kernel tiles the block itself.
    """

    def __init__(self, mesh: DeviceMesh, max_dist: float = 2.0,
                 max_iter: int = 10, axis: str = "cells",
                 ref_tile: int = 1024):
        self.mesh = mesh
        self.axis = axis
        self.group = mesh.get_group(axis)
        self.device = rank_device(resolve_device(mesh.device_type).type)
        self.max_dist = float(max_dist)
        self.max_iter = int(max_iter)

    def _tensor(self, x, dtype) -> torch.Tensor:
        if isinstance(x, torch.Tensor) and x.device == self.device:
            return x.to(dtype)
        return upload(x, self.device, dtype)

    def solve(self, read_pos, read_mask, map_pos, map_norm, map_mask
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """``read_*`` are the replicated reading ([N, D], [N]); ``map_*``
        this rank's block ([B, cap, D] as ``multihost.make_global_array``
        gives it, or [cap, D]).  Returns ``(T, overlap, rms)`` as 0-d / 4x4
        tensors on the rank's device, equal on every rank."""
        f32 = torch.float32
        p0 = self._tensor(read_pos, f32)
        rm = self._tensor(read_mask, torch.bool)
        dim = p0.shape[1]
        dof = 6 if dim == 3 else 3
        mp = self._tensor(map_pos, f32).reshape(-1, dim)
        mn = self._tensor(map_norm, f32).reshape(-1, dim)
        mm = self._tensor(map_mask, torch.bool).reshape(-1)
        pack = pack_refs(mp, mm) if mp.is_cuda else None
        max_dist2 = self.max_dist * self.max_dist
        n_read = torch.clamp(rm.to(f32).sum(), min=1.0)
        eye = torch.eye(dof, dtype=f32, device=self.device)
        T = torch.eye(dim + 1, dtype=f32, device=self.device)
        overlap = rms = torch.zeros((), dtype=f32, device=self.device)
        for _ in range(self.max_iter):
            p = se3.apply_points(T, p0)
            d2, idx = nn1(p, mp, rm, mm, pack=pack)
            d2 = torch.where(rm, d2, torch.full_like(d2, float("inf")))
            # the global winner of each reading point over the axis
            gmin = d2.clone()
            dist.all_reduce(gmin, op=dist.ReduceOp.MIN, group=self.group)
            mine = (d2 <= gmin) & torch.isfinite(gmin) & (gmin <= max_dist2)
            # an exact tie across ranks splits the weight
            claims = mine.to(f32)
            dist.all_reduce(claims, op=dist.ReduceOp.SUM, group=self.group)
            w = torch.where(mine, 1.0 / torch.clamp(claims, min=1.0),
                            torch.zeros_like(claims))
            j = torch.clamp(idx, min=0)
            q, qn = mp[j], mn[j]
            r = torch.sum(qn * (p - q), dim=1)
            if dim == 3:
                J = torch.cat([qn, torch.cross(p, qn, dim=1)], dim=1)
            else:
                cross2 = p[:, 0] * qn[:, 1] - p[:, 1] * qn[:, 0]
                J = torch.cat([qn, cross2[:, None]], dim=1)
            Jw = J * w[:, None]
            # one collective for JtJ, Jtr, the weight sum (the overlap's
            # numerator too: each term of the reference's overlap sum is the
            # point's weight) and the weighted sum of squares
            packed = torch.cat([(Jw.T @ J).reshape(-1), Jw.T @ r,
                                torch.sum(w)[None], torch.sum(w * r * r)[None]])
            dist.all_reduce(packed, op=dist.ReduceOp.SUM, group=self.group)
            JtJ = packed[:dof * dof].reshape(dof, dof)
            Jtr = packed[dof * dof:dof * dof + dof]
            wsum, wrr = packed[-2], packed[-1]
            # relative damping, as icp/engine.py's minimizer
            lam = 1e-3 * torch.trace(JtJ) / dof + 1e-6
            # solve_ex: the damped matrix is never singular, and the error
            # check of linalg.solve would read on the host
            dx = -torch.linalg.solve_ex(JtJ + lam * eye, Jtr).result
            dT = se3.exp_se3(dx) if dim == 3 else se3.exp_se2(dx)
            T = dT @ T
            overlap = wsum / n_read
            rms = torch.sqrt(wrr / torch.clamp(wsum, min=1e-9))
        return T, overlap, rms
