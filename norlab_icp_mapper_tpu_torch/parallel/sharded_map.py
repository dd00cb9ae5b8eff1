"""The sharded per-scan mapper: the map split over the ranks of a mesh.

One rank per device, as ``parallel/multihost.py`` sets it up.  Each rank
holds one block of the map as plain tensors on its device -- positions,
normals, validity and ``probabilityDynamic`` -- and runs the whole per-scan
step on it: registration, the DynamicPoints update, the insert gate, voxel
decimation, halo-exchange surface normals and the dynamic-point cut.
``torch.distributed`` collectives stand where the JAX package's
``shard_map`` programs use ``pmin`` / ``psum`` / ``pmax`` / ``all_gather``
(NCCL on the card, gloo on the CPU; gloo also carries CUDA tensors).

Layout
------
A point's *home* rank comes in two levels: an avalanche hash maps its 2-D
ground cell to one of ``n_buckets`` virtual buckets, and a replicated
bucket->rank table (greedy bin packing of measured bucket weights, rebuilt
when the balance degrades) maps buckets to ranks::

    home(p) = table[mix32(floor(p.x / cell), floor(p.y / cell)) mod B]

``cell_size`` is snapped to a multiple of the voxel size and cells are
z-infinite columns, so a voxel never straddles two ranks: per-rank voxel
decimation is the global decimation.  Surface normals need neighbours
across ranks: every rank packs its points within ``normal_radius`` of a cell
edge into a fixed ``[H]`` halo buffer, the buffers are all-gathered, and
each rank uses the others' as ghost references.  The insert gate needs no
halo: every rank searches the (replicated) scan against its own block and
an ``all_reduce(MIN)`` elects the global nearest.

Communication per ICP iteration: one ``all_reduce(MIN)`` of the reading's
distances and one ``all_reduce(SUM)`` of the claims on matching iterations,
and one packed ``all_reduce(SUM)`` of the minimizer's sums.  Per merge: one
``all_reduce(MIN)`` for the insert gate, one ``all_gather`` of the halo and
two small reductions of the counts.  Window moves gather the bounded
eviction buffers to every rank.

The invariant that keeps the ranks in step
-----------------------------------------
Every collective must be entered by every rank, in the same order, or the
run hangs.  So every host decision is taken from values that are identical
on every rank: replicated host state (the table, the window, the cell
store, the scan count, the time stamps) and all-reduced device values read
back.  In particular:

- the merge decision: under ``delay`` a comparison of host time stamps (no
  read); under ``distance`` / ``overlap`` one read of the replicated flag;
- the pipeline's harvest depends on the scan count alone: on the CPU every
  scan is harvested at the next scan, on the card the scan ``PIPE_DEPTH``
  scans back, waiting on its event (never on whether an event happens to
  have passed, which differs between ranks);
- capacity, shrink and rebalance decisions come from all-reduced counts read
  every ``HARVEST_EVERY`` scans, and every rank takes the same capacity;
- eviction buffers are gathered to every rank, so each rank's cell store
  holds the same cells and restores feed identical inputs to ``insert``.

The solve: one masked iteration as a function of device state
(:class:`_ShardedLoop`).  Under NCCL on the card a scan's solve is one
replay of a CUDA graph of all ``max_iter`` iterations, the reductions
inside (:class:`_ShardedSolveGraph`; not a WHILE node: NCCL refuses to be
captured in a conditional body on four ranks); under gloo it runs as a
Python loop, which on the CPU stops at the replicated ``done``.

Random draws: the reading filters' draws come from a ``DrawSource`` seeded
alike on every rank and drawn in the same order; the step filters' draws
are keyed by that source's seed, its solve index (a host count, alike on
every rank) and the loop's device ``it`` (``draws.KeyedDraws``); the
octree's ``samplingMethod: 1`` draws come from a second source keyed by the
rank (the JAX package folds the rank into the key).

Every host read goes through :meth:`ShardedMapper._read`, which copies into
pinned memory without blocking and waits on an event; ``waits`` counts them
by cause.
"""
from __future__ import annotations

import collections
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .. import se3
from ..cell_manager import CellManager, RAMCellManager
from ..draws import (SITE_OCTREE_LEAF, SITE_OCTREE_PRIO, DrawSource,
                     resolve_device, upload)
from ..filters.core import FilterChain
from ..icp.engine import (GraphReplay, _counters, _invert,
                          _refuse_source_on_card, _rematch_every,
                          _restore_counters, _rot_angle_np, _take)
from ..map import (BUFFER_SIZE, CELL_SIZE, _to_inferior_grid,
                   _to_superior_grid, bin_points_to_cells,
                   collect_cells_in_bounds)
from ..mapper_modules.core import _spherical_angles, dynamic_points_bayes
from ..ops.eigen import sym_eig2_smallest, sym_eig3_smallest
from ..ops.graph_loop import loop_commit, no_gc
from ..ops.kabsch import kabsch_from_moments, p2p_moments
from ..ops.nn import nn1
from ..ops.nn_sweep import presort_ref, sweep_knn
from ..ops.pca import radius_pca
from ..ops.voxel import voxel_select
from ..points import PointBatch, _scatter_rows, bucket_capacity
from ..trajectory import Trajectory
from ..utils.tracing import record_overflow
from .multihost import rank_device

__all__ = ["ShardedMapConfig", "ShardedMapperStep", "ShardedMapper",
           "greedy_table", "incremental_moves", "shard_device"]

F32 = torch.float32
SUM, MIN, MAX = dist.ReduceOp.SUM, dist.ReduceOp.MIN, dist.ReduceOp.MAX
_RANK_SEED = 1_000_003  # the rank's octree draws: seed + _RANK_SEED * (r + 1)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# uint32 avalanche (murmur3-finalizer family) over the 2-D ground cell
_BK1 = 0x9E3779B1
_BK2 = 0x85EBCA77
_BM1 = 0x7FEB352D
_BM2 = 0x846CA68B
_M32 = 0xFFFFFFFF


def _bucket_np(pos: np.ndarray, cell: float, B: int) -> np.ndarray:
    with np.errstate(over="ignore", invalid="ignore"):
        rx = np.floor(pos[:, 0] / cell).astype(np.int32).astype(np.uint32)
        ry = (np.floor(pos[:, 1] / cell).astype(np.int32).astype(np.uint32)
              if pos.shape[1] > 1 else np.zeros_like(rx))
        h = (rx * np.uint32(_BK1)) ^ (ry * np.uint32(_BK2))
        h ^= h >> np.uint32(16)
        h *= np.uint32(_BM1)
        h ^= h >> np.uint32(15)
        h *= np.uint32(_BM2)
        h ^= h >> np.uint32(16)
    return (h % np.uint32(B)).astype(np.int32)


def _cell_u32(x: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """``floor(x / cell)`` as numpy's ``astype(int32).astype(uint32)`` gives
    it, in int64: a value outside int32 (or NaN) becomes -2**31, as the x86
    conversion numpy uses makes it (CUDA's conversion would saturate)."""
    f = torch.floor(x / cell)  # true division: cell is a tensor, not a scalar
    ok = (f >= -2.0 ** 31) & (f < 2.0 ** 31)
    i = torch.where(ok, f, torch.full_like(f, -2.0 ** 31)).to(torch.int64)
    return i & _M32


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for x, c < 2**32 without leaving int64: the
    product is split at 16 bits of ``c`` so that nothing overflows."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _bucket_torch(pos: torch.Tensor, cell: float, B: int) -> torch.Tensor:
    """:func:`_bucket_np` on tensors, bit for bit: torch has no uint32
    multiply on CUDA, so the hash runs in int64 masked to 32 bits."""
    # a device tensor (a fill, no copy from the host): a host scalar
    # divisor becomes a multiply by its reciprocal on the card
    c = pos.new_full((), cell, dtype=F32)
    rx = _cell_u32(pos[:, 0], c)
    ry = _cell_u32(pos[:, 1], c) if pos.shape[1] > 1 else torch.zeros_like(rx)
    h = _mul32(rx, _BK1) ^ _mul32(ry, _BK2)
    h = h ^ (h >> 16)
    h = _mul32(h, _BM1)
    h = h ^ (h >> 15)
    h = _mul32(h, _BM2)
    h = h ^ (h >> 16)
    return h % B


def greedy_table(weights: np.ndarray, S: int) -> np.ndarray:
    """Bucket->rank table: heaviest-first greedy bin packing of measured
    bucket weights (zero-weight buckets round-robin so unseen terrain
    spreads too)."""
    B = weights.shape[0]
    table = np.zeros(B, np.int32)
    loads = np.zeros(S, np.float64)
    order = np.argsort(-weights, kind="stable")
    occupied = weights[order] > 0
    for i, b in enumerate(order[occupied]):
        s = int(np.argmin(loads))
        table[b] = s
        loads[s] += weights[b]
    empty = order[~occupied]
    table[empty] = np.arange(len(empty)) % S
    return table


def incremental_moves(weights: np.ndarray, table: np.ndarray, S: int,
                      target: float) -> Tuple[np.ndarray, np.ndarray]:
    """Move as few buckets as possible (heaviest rank -> lightest) until
    mean/max balance reaches ``target``.  Returns (new_table,
    moved_off_per_rank)."""
    new = table.copy()
    loads = np.bincount(new, weights=weights, minlength=S).astype(np.float64)
    moved_off = np.zeros(S, np.int64)
    for _ in range(4 * S * 8):
        if loads.max() <= 0 or loads.mean() / loads.max() >= target:
            break
        h = int(np.argmax(loads))
        l = int(np.argmin(loads))
        gap = loads[h] - loads[l]
        cand = np.nonzero((new == h) & (weights > 0))[0]
        if cand.size == 0:
            break
        w = weights[cand]
        fits = w <= gap / 2
        if fits.any():
            b = cand[fits][int(np.argmax(w[fits]))]
        else:
            b = cand[int(np.argmin(w))]
            if weights[b] >= gap:  # moving would overshoot -- done
                break
        new[b] = l
        loads[h] -= weights[b]
        loads[l] += weights[b]
        moved_off[h] += int(weights[b])
    return new, moved_off


class ShardedMapConfig:
    """Static knobs of the sharded per-scan step.

    ``dynamic_points``: optional dict of DynamicPointsMapperModule params
    (``thresholdDynamic, alpha, beta, beamHalfAngle, epsilonA, epsilonD,
    sensorMaxRange``); when set, the Bayesian probability update runs inside
    the merge, before the insert.

    ``sensor_max_range`` + ``window_enabled``: the rolling window -- the
    local window spans ``2*sensorMaxRange + 2*BUFFER_SIZE*CELL_SIZE`` per
    axis; out-of-window points are evicted to the host CellManager.

    ``step_filter``: a mask-only callable ``(PointBatch, draws) ->
    PointBatch`` re-applied to the moved reading at every matcher pass; a
    row-local ``FilterChain``'s ``_apply_impl`` (what the facade passes)
    also takes ``rows`` and then filters the sorted reading as it is.
    """

    def __init__(self, dim: int = 3,
                 cell_size: float = 4.8,
                 voxel_size: float = 0.15,
                 min_dist_new_point: float = 0.0,
                 normal_radius: float = 2.0,
                 normal_min_knn: int = 5,
                 match_max_dist: float = 2.0,
                 max_iter: int = 10,
                 minimizer: str = "PointToPlaneErrorMinimizer",
                 update_condition: str = "delay",
                 update_value: float = 0.05,
                 cut_threshold: Optional[float] = None,
                 outlier_filters=None,
                 step_filter=None,
                 halo_capacity: int = 4096,
                 ref_tile: int = 1024,
                 sampling_method: int = 1,
                 max_point_by_node: int = 1,
                 sensor_max_range: float = 200.0,
                 window_enabled: bool = True,
                 evict_capacity: int = 16384,
                 dynamic_points: Optional[Dict[str, float]] = None,
                 trimmed_ratio: Optional[float] = None,
                 diff_checker: Optional[Tuple[float, float, int]] = None,
                 n_buckets: int = 4096,
                 rebalance_below: float = 0.95,
                 rebalance_target: float = 0.98,
                 bound_checker: Optional[Tuple[float, float]] = None,
                 inspect: bool = False):
        if voxel_size > 0:
            # snap cell_size to a voxel multiple: a voxel never straddles a
            # rank boundary, so per-rank decimation == global decimation
            cell_size = max(1, round(cell_size / voxel_size)) * voxel_size
        self.dim = dim
        self.cell_size = float(cell_size)
        self.voxel_size = float(voxel_size)
        self.min_dist_new_point = float(min_dist_new_point)
        self.normal_radius = float(normal_radius)
        self.normal_min_knn = int(normal_min_knn)
        self.match_max_dist = float(match_max_dist)
        self.max_iter = int(max_iter)
        self.minimizer = minimizer
        self.update_condition = update_condition
        self.update_value = float(update_value)
        self.cut_threshold = cut_threshold
        self.halo_capacity = int(halo_capacity)
        self.ref_tile = int(ref_tile)
        self.sampling_method = int(sampling_method)
        self.sensor_max_range = float(sensor_max_range)
        self.window_enabled = bool(window_enabled)
        self.evict_capacity = int(evict_capacity)
        self.dynamic_points = (dict(dynamic_points)
                               if dynamic_points is not None else None)
        self.trimmed_ratio = (float(trimmed_ratio)
                              if trimmed_ratio is not None else None)
        # the outlier-filter chain: ordered (kind, param) pairs --
        # "trimmed" / "maxdist" / "median" / "normal"; trimmed_ratio is the
        # single-filter spelling
        if outlier_filters is not None:
            self.outlier_filters = tuple(
                (str(k), float(p)) for k, p in outlier_filters)
            for k, _ in self.outlier_filters:
                if k == "trimmed" and self.trimmed_ratio is None:
                    self.trimmed_ratio = dict(self.outlier_filters)["trimmed"]
        elif self.trimmed_ratio is not None:
            self.outlier_filters = (("trimmed", self.trimmed_ratio),)
        else:
            self.outlier_filters = ()
        self.step_filter = step_filter
        self.diff_checker = (tuple(diff_checker)
                             if diff_checker is not None else None)
        self.n_buckets = int(n_buckets)
        self.rebalance_below = float(rebalance_below)
        self.rebalance_target = float(rebalance_target)
        # BoundTransformationChecker (maxRotationNorm, maxTranslationNorm):
        # the loop stops at the bound; the facade raises on the host
        self.bound_checker = (tuple(float(v) for v in bound_checker)
                              if bound_checker is not None else None)
        # PerformanceInspector: the solve also returns a per-iteration
        # (overlap, rms) history [max_iter, 2]
        self.inspect = bool(inspect)
        self.max_point_by_node = int(max_point_by_node)
        # octree coarsening levels whose cells still nest inside the rank
        # cells (absolute alignment): per-rank K>1 decimation then equals
        # the global decimation, like the voxel snap above
        lvl = 0
        while voxel_size > 0 and lvl < 10:
            edge = voxel_size * (2 ** (lvl + 1))
            ratio = cell_size / edge
            if edge > cell_size + 1e-6 or abs(round(ratio) - ratio) > 1e-6:
                break
            lvl += 1
        self.octree_levels = lvl


class _Window:
    """Host-side rolling-window bookkeeping with the reference's 2-cell
    hysteresis; the device predicate is the window box (window edges padded
    by BUFFER_SIZE cells)."""

    def __init__(self, dim: int, sensor_max_range: float):
        self.dim = dim
        self.rng = float(sensor_max_range)
        self.w: Optional[List[int]] = None  # [inf_x, sup_x, inf_y, ...]

    def _edges(self, p: np.ndarray) -> Tuple[List[int], List[int]]:
        inf = [_to_inferior_grid(float(p[a]), self.rng)
               for a in range(self.dim)]
        sup = [_to_superior_grid(float(p[a]), self.rng)
               for a in range(self.dim)]
        return inf, sup

    def first(self, pose: np.ndarray) -> None:
        p = np.asarray(pose)[: self.dim, self.dim]
        inf, sup = self._edges(p)
        self.w = []
        for a in range(self.dim):
            self.w += [inf[a], sup[a]]

    def advance(self, pose: np.ndarray) -> bool:
        """Shift window edges that moved >= 2 cells; True if any changed."""
        if self.w is None:
            self.first(pose)
            return True
        p = np.asarray(pose)[: self.dim, self.dim]
        inf, sup = self._edges(p)
        changed = False
        for a in range(self.dim):
            if abs(inf[a] - self.w[2 * a]) >= 2:
                self.w[2 * a] = inf[a]
                changed = True
            if abs(sup[a] - self.w[2 * a + 1]) >= 2:
                self.w[2 * a + 1] = sup[a]
                changed = True
        return changed

    def box(self) -> Tuple[np.ndarray, np.ndarray]:
        """World-coordinate box of the buffered window (per-axis lo/hi)."""
        B = BUFFER_SIZE
        lo = np.array([(self.w[2 * a] - B) * CELL_SIZE
                       for a in range(self.dim)], np.float32)
        hi = np.array([(self.w[2 * a + 1] + 1 + B) * CELL_SIZE
                       for a in range(self.dim)], np.float32)
        return lo, hi

    def grid_bounds(self) -> Tuple[int, int, int, int, int, int]:
        B = BUFFER_SIZE
        b = []
        for a in range(3):
            if a < self.dim:
                b += [self.w[2 * a] - B, self.w[2 * a + 1] + B]
            else:
                b += [0, 0]
        return tuple(b)


def _row_local(step_filter) -> bool:
    """Whether a step filter is a row-local chain's ``_apply_impl`` (the
    facade's kind), which takes ``rows``; any other callable is not."""
    chain = getattr(step_filter, "__self__", None)
    return isinstance(chain, FilterChain) and chain.row_local


def shard_device(mesh, device=None) -> torch.device:
    """The device a rank's block lives on: ``device`` (default the card,
    raising without one), with a CUDA device given its index.  Under NCCL
    (a ``"cuda"`` mesh) it must be the rank's own card; a gloo mesh takes
    any device, CUDA tensors included."""
    dev = resolve_device(device)
    if mesh.device_type == "cuda" and dev.type != "cuda":
        raise ValueError(f"device {dev} contradicts the mesh: an NCCL mesh "
                         "holds each rank's block on its card")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if mesh.device_type == "cuda" and dev != rank_device("cuda"):
        raise ValueError(
            f"device {dev} contradicts the mesh: this rank's NCCL device is "
            f"{rank_device('cuda')}")
    return dev


class ShardedMapperStep:
    """The per-scan step over this rank's block of the map.

    State (this rank's block, on ``device``):
      pos   f32[cap, D]    map positions
      nrm   f32[cap, D]    surface normals
      msk   bool[cap]      validity
      prob  f32[cap]       probabilityDynamic (zeros when unused)

    Methods (each enters the same collectives on every rank):
      register   the distributed ICP solve (read-only on the state)
      merge      DynamicPoints, insert gate, scatter insert, decimation,
                 halo normals, cut
      evict      window partition -> this rank's eviction buffer
      insert     re-home replicated points into free slots (restore path)
      bucket_hist, rebalance, compact
    Mirrors (the counts and overflows) come back all-reduced: the same
    device values on every rank.
    """

    GRAPHS_KEPT = 2  # solve graphs kept (block capacities change rarely)

    def __init__(self, mesh, cfg: ShardedMapConfig, axis: str = "cells",
                 device=None):
        self.mesh = mesh
        self.axis = axis
        self.cfg = cfg
        self.group = mesh.get_group(axis)
        self.n_shards = int(mesh.size(mesh.mesh_dim_names.index(axis)))
        self.rank = int(mesh.get_local_rank(axis))
        self.device = shard_device(mesh, device)
        # sorted queries per window of the searches whose queries are this
        # rank's block (the angular 1-NN, the halo PCA): a block holds 1/S
        # of the map, so S-fold fewer queries per tile keep a tile's extent,
        # and with it its window's reach, what one rank's is (1,024 queries
        # at S=1; a multiple of the kernels' 256-query blocks)
        self.block_q_tile = max(256, (1024 // self.n_shards) // 256 * 256)
        # the solve graphs under NCCL, by shapes (most recently used last)
        self._graphs: "collections.OrderedDict" = collections.OrderedDict()
        self.graph_captures = 0

    # ------------------------------------------------------- collectives
    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.group)
        return t

    def _gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` stacked along a new leading axis (bool goes
        through uint8: not every backend gathers bool)."""
        src = t.to(torch.uint8) if t.dtype == torch.bool else t.contiguous()
        out = [torch.empty_like(src) for _ in range(self.n_shards)]
        dist.all_gather(out, src, group=self.group)
        g = torch.stack(out)
        return g.to(torch.bool) if t.dtype == torch.bool else g

    def _counts(self, msk: torch.Tensor, *sums: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """``count`` (sum over ranks), ``max_shard_count`` and the sums of
        ``sums`` over the ranks: two reductions."""
        c = msk.sum().to(torch.int64)
        s = self._reduce(torch.stack([c] + [x.to(torch.int64) for x in sums]),
                         SUM)
        mx = self._reduce(c.reshape(1).clone(), MAX)
        out = {"count": s[0], "max_shard_count": mx[0]}
        for i in range(len(sums)):
            out[f"sum{i}"] = s[1 + i]
        return out

    # ------------------------------------------------------------- homes
    def bucket_of(self, positions: np.ndarray) -> np.ndarray:
        return _bucket_np(positions, self.cfg.cell_size, self.cfg.n_buckets)

    def home_of(self, positions: np.ndarray,
                table: np.ndarray) -> np.ndarray:
        return table[self.bucket_of(positions)]

    def home_dev(self, positions: torch.Tensor,
                 table: torch.Tensor) -> torch.Tensor:
        return table[_bucket_torch(positions, self.cfg.cell_size,
                                   self.cfg.n_buckets)]

    def init_state(self, batch: PointBatch, table: np.ndarray,
                   capacity: Optional[int] = None):
        """Pack a PointBatch into per-rank blocks (once, at bootstrap or
        restore) and keep this rank's."""
        data = batch.to_numpy()
        pos = data["positions"]
        S = self.n_shards
        home = self.home_of(pos, table)
        counts = np.bincount(home, minlength=S)
        cap = capacity or max(1024, _round_up(int(counts.max() * 2 + 1024),
                                              1024))
        D = self.cfg.dim
        st_pos = np.zeros((S, cap, D), np.float32)
        st_nrm = np.zeros((S, cap, D), np.float32)
        st_msk = np.zeros((S, cap), bool)
        st_prob = np.zeros((S, cap), np.float32)
        nrm = data.get("normals")
        prob = data.get("probabilityDynamic")
        for s in range(S):
            idx = np.nonzero(home == s)[0][:cap]
            k = len(idx)
            st_pos[s, :k] = pos[idx]
            st_msk[s, :k] = True
            if nrm is not None:
                st_nrm[s, :k] = nrm[idx][:, :D]
            if prob is not None:
                st_prob[s, :k] = prob[idx].reshape(k, -1)[:, 0]
        return self.put_state({"pos": st_pos, "nrm": st_nrm, "msk": st_msk,
                               "prob": st_prob})

    def put_state(self, blocks: Dict[str, np.ndarray]):
        """The ``[S, cap, ...]`` blocks every rank passes whole; this rank
        keeps block ``rank`` on its device (``multihost.make_global_array``'s
        rule)."""
        S = np.asarray(blocks["pos"]).shape[0]
        if S != self.n_shards:
            raise ValueError(f"{S} blocks for {self.n_shards} ranks")
        dtypes = {"pos": F32, "nrm": F32, "msk": torch.bool, "prob": F32}
        return {k: upload(np.ascontiguousarray(np.asarray(blocks[k])[
            self.rank]), self.device, dt) for k, dt in dtypes.items()}

    def gather_state(self, state) -> Dict[str, np.ndarray]:
        """Every rank's block as host ``[S, cap, ...]`` arrays, on every
        rank (the end of a run, checkpoints)."""
        return {k: self._gather(v).cpu().numpy() for k, v in state.items()}

    # ------------------------------------------------------- shared parts
    @staticmethod
    def _scatter_insert(pos, nrm, msk, prob, new_pos, new_nrm, new_prob,
                        take):
        """Scatter ``take``-marked rows of the new arrays into free slots of
        the block; rows beyond the free-slot count are dropped and counted
        (the caller sizes the capacity so that this does not fire)."""
        cap = msk.shape[0]
        slot_of_free = torch.argsort(msk.to(torch.int8), stable=True)
        take_rank = torch.cumsum(take.to(torch.int64), 0) - 1
        n_free = (~msk).sum()
        ok = take & (take_rank < n_free)
        overflow = (take & ~ok).sum()
        dst = slot_of_free[torch.clamp(take_rank, 0, cap - 1)]
        dst = torch.where(ok, dst, torch.full_like(dst, cap))  # dropped
        pos = _scatter_rows(pos, dst, new_pos)
        nrm = _scatter_rows(nrm, dst, new_nrm)
        prob = _scatter_rows(prob, dst, new_prob)
        msk = _scatter_rows(msk, dst, torch.ones_like(take))
        return pos, nrm, msk, prob, overflow

    @staticmethod
    def _compact_halo(pos, msk, prob, sel, H: int):
        """Pack the points where ``sel`` into a fixed [H] buffer (selected
        first, order kept)."""
        keep = sel & msk
        order = torch.argsort((~keep).to(torch.int8), stable=True)
        top = order[:H]
        overflow = torch.clamp(keep.sum() - H, min=0)
        return pos[top], keep[top], prob[top], overflow

    def _step_mask(self, p, read_mask, draws, order=None, inv=None):
        """readingStepDataPointsFilters: a fresh mask of the moved reading
        at every matcher pass, its draws replicated on every rank (keyed,
        or a caller's source).  On a reading the matcher sorted (``order``,
        ``inv`` its inverse) every draw lands on the point it lands on in
        an unsorted solve: a row-local chain is handed ``order`` as its
        ``rows`` (:meth:`_step_mask_in_rows`), any other chain filters the
        reading permuted back to its original order
        (:meth:`_step_mask_permuted`)."""
        if self.cfg.step_filter is None:
            return read_mask
        if _row_local(self.cfg.step_filter):
            return self._step_mask_in_rows(p, read_mask, draws, order)
        return self._step_mask_permuted(p, read_mask, draws, order, inv)

    def _step_mask_in_rows(self, p, read_mask, draws, order):
        """A row-local chain in the solve's row order, ``rows=order``; its
        mask holds ``read_mask`` already."""
        return self.cfg.step_filter(PointBatch(p, read_mask, {}), draws,
                                    rows=order).mask

    def _step_mask_permuted(self, p, read_mask, draws, order, inv):
        """Any chain (a callable ``(PointBatch, draws) -> PointBatch``) on
        the reading in its original row order, the mask permuted forward."""
        if order is None:
            return read_mask & self.cfg.step_filter(
                PointBatch(p, read_mask, {}), draws).mask
        return read_mask & self.cfg.step_filter(
            PointBatch(p[inv], read_mask[inv], {}), draws).mask[order]

    def _matcher(self, read_pos, read_mask, map_pos, map_msk):
        """Per-solve matcher ``match(p, cur) -> (d2 [N], idx [N], overflow)``
        (d2 = inf beyond the radius), the reading it runs on, the order
        that sorted it and that order's inverse (None if unsorted; the
        inverse also None where the step chain does not permute, see
        :meth:`_step_mask`).  ``ref_tile`` is not used: the
        brute-force 1-NN is ``ops.nn.nn1`` (``knn_brute`` on the card),
        which tiles the block itself.  With a finite ``match_max_dist`` the
        reading is sorted by x once and every pass is the sorted sweep over
        the block's hoisted pack; every rank sorts the same replicated
        reading alike, so the per-query reductions stay aligned.  Without a
        radius it is the brute-force 1-NN."""
        cfg = self.cfg
        if not np.isfinite(cfg.match_max_dist):
            def match_bf(p, cur):
                d2, idx = nn1(p, map_pos, cur, map_msk)
                return d2, idx, None
            return match_bf, read_pos, read_mask, None, None
        pre = presort_ref(map_pos, map_msk)
        q_x = torch.where(read_mask, read_pos[:, 0],
                          torch.full_like(read_pos[:, 0], 1e9))
        order = torch.sort(q_x, stable=True).indices
        read_pos = read_pos[order]
        read_mask = read_mask[order]
        step = cfg.step_filter
        inv = (_invert(order) if step is not None and not _row_local(step)
               else None)

        def match_sweep(p, cur):
            d2, idx, ov = sweep_knn(p, map_pos, cur, map_msk, k=1,
                                    max_radius=cfg.match_max_dist,
                                    q_tile=1024, W=8192, presorted=pre,
                                    assume_sorted=True)
            return d2[:, 0], idx[:, 0], ov
        return match_sweep, read_pos, read_mask, order, inv

    # ------------------------------------------------------------- solve
    def icp_solve(self, read_pos, read_mask, map_pos, map_nrm, map_msk,
                  draws=None):
        """The distributed solve: point-to-plane Gauss-Newton (reduced
        ``JtJ`` / ``Jtr``), point-to-point weighted Kabsch (reduced cross
        moments, ``ops/kabsch.py`` on the device) or Identity (overlap
        only).

        The loop is :class:`_ShardedLoop`: its state on the device, one
        masked iteration a function of it.  Under NCCL on the card the
        solve is one replay of a CUDA graph (:class:`_ShardedSolveGraph`)
        of all ``max_iter`` iterations, collectives inside, with no host
        read; under gloo the same iterations run as a Python loop, which on
        the CPU reads the replicated ``done`` and stops.  Step filters draw
        keyed by the replicated seed and solve index, so every rank derives
        the same mask.  Returns ``(T, overlap, iters, ihist)``, equal on
        every rank; the matcher's overflowing tiles are recorded once, from
        a device count."""
        cfg = self.cfg
        step = cfg.step_filter
        if step is not None and draws is None:
            draws = DrawSource(0)
        _refuse_source_on_card(step, draws, read_pos.device)
        index = (draws.next_solve()
                 if step is not None and draws.source is None else 0)
        args = (read_pos, read_mask, map_pos, map_nrm, map_msk)
        # gloo's collectives cannot be captured: there the Python loop runs
        if (read_pos.is_cuda
                and dist.get_backend(self.group) == "nccl"):
            out = self._graph(args, draws).run(*args, solve_index=index)
        else:
            loop = _ShardedLoop(self, *args, draws=draws,
                                solve_index=torch.full(
                                    (), index, dtype=torch.int64,
                                    device=read_pos.device))
            out = loop.run(stop=read_pos.device.type == "cpu")
        T, overlap, iters, ihist, overflow = out
        if np.isfinite(cfg.match_max_dist):
            record_overflow("sharded_matcher_sweep", overflow)
        return T, overlap, iters, ihist

    def close(self) -> None:
        """Free the solve graphs.  NCCL does not destroy a communicator
        while a graph that captured its collectives lives, so this comes
        before ``destroy_process_group``."""
        for graph in self._graphs.values():
            graph.close()
        self._graphs.clear()

    def _graph(self, args, draws) -> "_ShardedSolveGraph":
        """The cached solve graph for these shapes (the block's capacity),
        the rematch period and the draws' seed, captured on first use; every
        rank captures at the same scan (the capacity is replicated)."""
        seed = None if self.cfg.step_filter is None else draws.seed
        key = (tuple(tuple(t.shape) for t in args), _rematch_every(), seed)
        graph = self._graphs.pop(key, None)
        if graph is None:
            graph = _ShardedSolveGraph(self, *args, draws=draws)
            self.graph_captures += 1
            while len(self._graphs) >= self.GRAPHS_KEPT:
                self._graphs.popitem(last=False)[1].close()
        self._graphs[key] = graph
        return graph

    def register(self, state, scan_pos, read_mask, est_pose, draws=None):
        """The solve of one scan against the map (the state is read, not
        changed).  Returns ``pose`` (corrected), ``correction``,
        ``overlap``, ``iters`` and ``ihist`` as device tensors."""
        scan_m = se3.apply_points(est_pose, scan_pos)
        correction, overlap, iters, ihist = self.icp_solve(
            scan_m, read_mask, state["pos"], state["nrm"], state["msk"],
            draws)
        return {"pose": correction @ est_pose, "correction": correction,
                "overlap": overlap, "iters": iters, "ihist": ihist}

    # ------------------------------------------------------------- merge
    def _dp_update(self, pos, nrm, msk, prob, scan_pos, scan_mask,
                   corrected):
        """DynamicPointsMapperModule inside the merge: this rank's block
        against the replicated scan in the sensor frame, with no collective
        (the scan is on every rank)."""
        dp = self.cfg.dynamic_points
        dim = self.cfg.dim
        inv = se3.inverse(corrected)
        # the scan went sensor->map by (correction @ est); its sensor-frame
        # positions are scan_pos itself
        scan_s = scan_pos
        map_s = se3.apply_points(inv, pos)
        normals_s = nrm @ inv[:dim, :dim].T
        scan_r = torch.linalg.norm(scan_s, dim=1)
        map_r = torch.linalg.norm(map_s, dim=1)
        in_range = msk & (map_r < dp["sensorMaxRange"])
        scan_ang = _spherical_angles(scan_s, scan_r)
        map_ang = _spherical_angles(map_s, map_r)
        radius = 2.0 * dp["beamHalfAngle"]
        d2s, idxs, ova = sweep_knn(map_ang, scan_ang, in_range, scan_mask,
                                   k=1, max_radius=radius,
                                   q_tile=self.block_q_tile, W=1024)
        record_overflow("sharded_dp_angular_sweep", ova)
        return dynamic_points_bayes(
            scan_s, scan_r, map_s, map_r, normals_s, prob, d2s[:, 0],
            idxs[:, 0], in_range, dp["thresholdDynamic"], dp["alpha"],
            dp["beta"], dp["beamHalfAngle"], dp["epsilonA"], dp["epsilonD"])

    def merge_update(self, state, table, scan_pos, scan_mask, scan_prob,
                     scan_c, corrected, shard_draws=None):
        """The merge body on this rank's block.  Returns the new state and
        this rank's insert and halo overflow counts."""
        cfg = self.cfg
        pos, nrm, msk, prob = (state["pos"], state["nrm"], state["msk"],
                               state["prob"])
        inf = float("inf")
        # DynamicPoints first (the reference's module order)
        if cfg.dynamic_points is not None:
            prob = self._dp_update(pos, nrm, msk, prob, scan_pos, scan_mask,
                                   corrected)
        # the insert gate (PointDistanceMapperModule): "is there a map point
        # within minDistNewPoint", the sweep's radius being the gate itself,
        # then the global minimum over the ranks
        if cfg.min_dist_new_point > 0:
            d2s, _, ovg = sweep_knn(scan_c, pos, scan_mask, msk, k=1,
                                    max_radius=cfg.min_dist_new_point,
                                    q_tile=1024, W=8192,
                                    presorted=presort_ref(pos, msk))
            record_overflow("sharded_insert_gate_sweep", ovg)
            d2 = torch.where(scan_mask, d2s[:, 0],
                             torch.full_like(d2s[:, 0], inf))
            gmin = self._reduce(d2, MIN)
            thr = float(np.float32(cfg.min_dist_new_point ** 2))
            is_new = scan_mask & ~(gmin < thr)
        else:
            is_new = scan_mask
        mine = is_new & (self.home_dev(scan_c, table) == self.rank)
        pos, nrm, msk, prob, ins_of = self._scatter_insert(
            pos, nrm, msk, prob, scan_c, torch.zeros_like(scan_c), scan_prob,
            mine)

        # voxel decimation (OctreeMapperModule), exact per rank
        if cfg.voxel_size > 0:
            prio = leaf = None
            if cfg.sampling_method == 1:
                if shard_draws is None:
                    shard_draws = DrawSource(_RANK_SEED * (self.rank + 1),
                                             pos.device)
                prio = shard_draws.prio15(SITE_OCTREE_PRIO, pos.shape[0])
                if cfg.max_point_by_node > 1:
                    leaf = shard_draws.int30(SITE_OCTREE_LEAF, pos.shape[0])
            keep, _ = voxel_select(
                pos, msk, cfg.voxel_size, method=cfg.sampling_method,
                prio15=prio, max_point_by_node=cfg.max_point_by_node,
                max_coarsen_levels=cfg.octree_levels, leaf_keys=leaf)
            msk = msk & keep

        # the halo: every rank's points within r of a cell edge, gathered;
        # a cross-rank neighbour of a point lies within r of its own cell's
        # edge, so this rank's block plus the ghosts make the PCA exact
        r_norm = cfg.normal_radius
        cs = cfg.cell_size
        fx = pos[:, 0] - torch.floor(pos[:, 0] / cs) * cs
        near = (fx < r_norm) | (fx > cs - r_norm)
        if cfg.dim > 1:
            fy = pos[:, 1] - torch.floor(pos[:, 1] / cs) * cs
            near = near | (fy < r_norm) | (fy > cs - r_norm)
        h_pos, h_val, _, halo_of = self._compact_halo(
            pos, msk, prob, near, cfg.halo_capacity)
        all_pos = self._gather(h_pos)  # [S, H, D]
        all_val = self._gather(h_val)  # [S, H]
        # this rank's own points are local
        others = torch.arange(self.n_shards, device=pos.device) != self.rank
        all_val = all_val & others[:, None]
        ref_pos = torch.cat([pos, all_pos.reshape(-1, pos.shape[1])])
        ref_msk = torch.cat([msk, all_val.reshape(-1)])
        cnt, _, cov, pca_of = radius_pca(
            pos, ref_pos, msk, ref_msk, r_norm, q_tile=self.block_q_tile,
            W=2048 if r_norm <= 1.0 else 4096)
        record_overflow("sharded_pca_sweep", pca_of)
        eig = sym_eig3_smallest if cfg.dim == 3 else sym_eig2_smallest
        _, normal = eig(cov)
        good = cnt >= cfg.normal_min_knn
        nrm = torch.where((msk & good)[:, None], normal, nrm)

        # CutAtDescriptorThreshold (post filter)
        if cfg.cut_threshold is not None:
            msk = msk & ~(prob > cfg.cut_threshold)
        return ({"pos": pos, "nrm": nrm, "msk": msk, "prob": prob},
                ins_of, halo_of)

    def merge(self, state, table, scan_pos, scan_mask, scan_prob, correction,
              est_pose, shard_draws=None):
        """One merge.  Returns the new state and its mirrors: ``count``,
        ``max_shard_count``, ``insert_overflow``, ``halo_overflow`` (this
        merge's, summed over the ranks)."""
        scan_m = se3.apply_points(est_pose, scan_pos)
        corrected = correction @ est_pose
        scan_c = se3.apply_points(correction, scan_m)
        state, ins_of, halo_of = self.merge_update(
            state, table, scan_pos, scan_mask, scan_prob, scan_c, corrected,
            shard_draws)
        m = self._counts(state["msk"], ins_of, halo_of)
        return state, {"count": m["count"],
                       "max_shard_count": m["max_shard_count"],
                       "insert_overflow": m["sum0"],
                       "halo_overflow": m["sum1"]}

    # ------------------------------------------------------- maintenance
    def evict(self, state, win_lo, win_hi):
        """Move out-of-box points out of the block into a fixed ``[E]``
        eviction buffer.  Points that do not fit stay valid (counted as
        overflow, retried at the next scan), never dropped."""
        E = self.cfg.evict_capacity
        pos, nrm, msk, prob = (state["pos"], state["nrm"], state["msk"],
                               state["prob"])
        inside = torch.all((pos >= win_lo[None, :]) & (pos < win_hi[None, :]),
                           dim=1)
        out = msk & ~inside
        rank = torch.cumsum(out.to(torch.int64), 0) - 1
        fits = out & (rank < E)
        overflow = (out & ~fits).sum()
        order = torch.argsort((~out).to(torch.int8), stable=True)
        top = order[:E]
        valid = fits[top]
        msk = msk & ~fits
        bufs = {"pos": pos[top], "nrm": nrm[top], "prob": prob[top],
                "valid": valid}
        m = self._counts(msk, valid.sum(), overflow)
        mirrors = {"evicted": m["sum0"], "evict_overflow": m["sum1"],
                   "count": m["count"],
                   "max_shard_count": m["max_shard_count"]}
        return {"pos": pos, "nrm": nrm, "msk": msk, "prob": prob}, bufs, \
            mirrors

    def insert(self, state, table, pos_new, nrm_new, prob_new, valid):
        """Insert replicated points, each rank taking its homed subset (the
        restore path)."""
        mine = valid & (self.home_dev(pos_new, table) == self.rank)
        pos, nrm, msk, prob, overflow = self._scatter_insert(
            state["pos"], state["nrm"], state["msk"], state["prob"],
            pos_new, nrm_new, prob_new, mine)
        m = self._counts(msk, overflow)
        return ({"pos": pos, "nrm": nrm, "msk": msk, "prob": prob},
                {"insert_overflow": m["sum0"], "count": m["count"],
                 "max_shard_count": m["max_shard_count"]})

    def bucket_hist(self, state) -> torch.Tensor:
        """Per-bucket point counts summed over the ranks (int64 [B])."""
        B = self.cfg.n_buckets
        bk = _bucket_torch(state["pos"], self.cfg.cell_size, B)
        bk = torch.where(state["msk"], bk, torch.full_like(bk, B))
        hist = torch.zeros((B + 1,), dtype=torch.int64, device=bk.device)
        hist.index_add_(0, bk, torch.ones_like(bk))
        return self._reduce(hist[:B].contiguous(), SUM)

    def rebalance(self, state, table_new, move_capacity: int):
        """Move every point whose bucket was reassigned to its new rank:
        this rank's movers packed into a ``[move_capacity]`` buffer, one
        gather, then each rank re-homes and scatter-inserts its share."""
        E = move_capacity
        pos, nrm, msk, prob = (state["pos"], state["nrm"], state["msk"],
                               state["prob"])
        moving = msk & (self.home_dev(pos, table_new) != self.rank)
        rank = torch.cumsum(moving.to(torch.int64), 0) - 1
        fits = moving & (rank < E)
        overflow = (moving & ~fits).sum()
        order = torch.argsort((~moving).to(torch.int8), stable=True)
        top = order[:E]
        valid = fits[top]
        msk = msk & ~fits
        D = pos.shape[1]
        g_pos = self._gather(pos[top]).reshape(-1, D)
        g_nrm = self._gather(nrm[top]).reshape(-1, D)
        g_prob = self._gather(prob[top]).reshape(-1)
        g_val = self._gather(valid).reshape(-1)
        take = g_val & (self.home_dev(g_pos, table_new) == self.rank)
        pos, nrm, msk, prob, ins_of = self._scatter_insert(
            pos, nrm, msk, prob, g_pos, g_nrm, g_prob, take)
        m = self._counts(msk, valid.sum(), overflow, ins_of)
        # movers that did not fit the buffer stay valid on their rank (only
        # `fits` rows were cleared); a destination overflow would lose
        # points, and the caller raises on it
        return ({"pos": pos, "nrm": nrm, "msk": msk, "prob": prob},
                {"moved": m["sum0"], "stayed_home": m["sum1"],
                 "insert_overflow": m["sum2"], "count": m["count"],
                 "max_shard_count": m["max_shard_count"]})

    def compact(self, state):
        """Valid points to the front of the block (order kept)."""
        order = torch.argsort((~state["msk"]).to(torch.int8), stable=True)
        new = {k: v[order] for k, v in state.items()}
        m = self._counts(new["msk"])
        return new, {"count": m["count"],
                     "max_shard_count": m["max_shard_count"]}


class _ShardedLoop:
    """The sharded solve of one scan as state tensors on the device and one
    masked iteration, the counterpart of ``icp/engine.py::_Loop`` with this
    rank's block and the step's collectives.

    The state is ``(T, it, done, overlap, hist)``, the inspector's history
    (written at the device ``it``) and the matcher's overflow count; every
    update is ``where(active, new, old)`` with ``active = !done && it <
    max_iter``, so an iteration after the stop changes no bit.  Iteration
    ``j`` of the loop re-matches when ``j % rematch_every == 0``: while the
    loop is live ``it == j``, the JAX schedule.  Step filters draw keyed by
    the solve index and the device ``it`` (or from a caller-supplied
    source, on the CPU only)."""

    def __init__(self, step: "ShardedMapperStep", read_pos, read_mask,
                 map_pos, map_nrm, map_msk, *, draws=None, solve_index):
        self.step, self.cfg = step, step.cfg
        self.read_pos, self.read_mask = read_pos, read_mask
        self.map_pos, self.map_nrm, self.map_msk = map_pos, map_nrm, map_msk
        self.draws = draws
        self.keyed = (self.cfg.step_filter is not None and draws is not None
                      and draws.source is None)
        self.solve_index = solve_index
        self.re_every = _rematch_every()
        self.dev = read_pos.device
        self.corr = None

    # ------------------------------------------------------------- state
    def start(self):
        cfg, dev = self.cfg, self.dev
        dim = cfg.dim
        self.n_read = torch.clamp(self.read_mask.to(F32).sum(), min=1.0)
        (self.match, self.read, self.mask, self.order,
         self.inv_order) = self.step._matcher(
            self.read_pos, self.read_mask, self.map_pos, self.map_msk)
        smooth = cfg.diff_checker[2] if cfg.diff_checker else 1
        n_hist = cfg.max_iter if cfg.inspect else 1
        dof = 6 if dim == 3 else 3
        self.eye_dof = torch.eye(dof, dtype=F32, device=dev)
        self.T = torch.eye(dim + 1, dtype=F32, device=dev)
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        self.overlap = torch.zeros((), dtype=F32, device=dev)
        self.hist = torch.full((smooth, 2), float("inf"), dtype=F32,
                               device=dev)
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.ihist = torch.zeros((n_hist, 2), dtype=F32, device=dev)
        self.overflow = torch.zeros((), dtype=torch.int64, device=dev)

    def outputs(self):
        """``(T, overlap, iters, ihist, overflow)`` on the device."""
        return self.T, self.overlap, self.it, self.ihist, self.overflow

    def run(self, stop: bool):
        """The loop under Python, every rank alike: ``max_iter`` masked
        iterations, or, with ``stop`` (on the CPU, where the read is free),
        until the replicated ``done``.  Returns :meth:`outputs`."""
        self.start()
        self.solve(stop)
        return self.outputs()

    def solve(self, stop: bool = False):
        """After :meth:`start`: Identity's one pass, or the iterations."""
        if self.cfg.minimizer == "IdentityErrorMinimizer":
            self._identity()
            return
        for j in range(self.cfg.max_iter):
            if stop and bool(self.done):
                break
            self.iteration(j % self.re_every)

    def _identity(self):
        """Identity: one pass, the overlap only."""
        cur = self.step._step_mask(self.read, self.mask, self._draws(),
                                   self.order, self.inv_order)
        d2, _, ov = self.match(self.read, cur)
        gmin = self.step._reduce(d2.clone(), MIN)
        max_d2 = float(np.float32(self.cfg.match_max_dist ** 2))
        self.overlap = (gmin <= max_d2).to(F32).sum() / self.n_read
        self.ihist[0, 0] = self.overlap
        self.it.fill_(1)
        if ov is not None:
            self.overflow = ov.to(torch.int64)

    # --------------------------------------------------------- iteration
    def _draws(self):
        return (self.draws.keyed(self.solve_index, self.it) if self.keyed
                else self.draws)

    def iteration(self, j: int):
        """One iteration, masked by ``active``; ``j`` is its place in the
        rematch period (0 re-matches)."""
        cfg = self.cfg
        p = se3.apply_points(self.T, self.read)
        fresh = j == 0 or self.corr is None
        if fresh:
            self.corr = self._match_pairs(p)
        q, qn, w, ov, overflow = self.corr
        if cfg.minimizer == "PointToPointErrorMinimizer":
            dT, rms = self._point_to_point(p, q, w)
        else:
            dT, rms = self._point_to_plane(p, q, qn, w)
        if cfg.inspect:
            active = ~self.done & (self.it < cfg.max_iter)
            row = torch.clamp(self.it, max=self.ihist.shape[0] - 1
                              ).to(torch.int64).reshape(1)
            old = self.ihist.index_select(0, row)
            new = torch.stack([ov, rms])[None]
            self.ihist.index_copy_(0, row, torch.where(active, new, old))
        # the rest of the commit in one loop_commit (a kernel on the card;
        # no WHILE node here, so it sets no condition)
        add = fresh and overflow is not None
        loop_commit(dT, self.T, self.it, self.done, self.hist, ov,
                    self.overlap, max_iter=cfg.max_iter,
                    overflow_new=overflow if add else None,
                    overflow=self.overflow if add else None,
                    diff_checker=cfg.diff_checker,
                    bound_checker=cfg.bound_checker)

    # ------------------------------------------------------------- pieces
    def _match_pairs(self, p):
        cfg = self.cfg
        inf = float("inf")
        reduce = self.step._reduce
        max_d2 = float(np.float32(cfg.match_max_dist * cfg.match_max_dist))
        cur = self.step._step_mask(p, self.mask, self._draws(), self.order,
                                   self.inv_order)
        d2, idx, overflow = self.match(p, cur)
        gmin = reduce(d2.clone(), MIN)
        matched = cur & torch.isfinite(gmin) & (gmin <= max_d2)
        overlap = matched.to(F32).sum() / self.n_read
        # the outlier chain in config order, on the reduced (global)
        # distances: every rank derives the same cuts
        good = matched
        for kind, param in cfg.outlier_filters:
            if kind == "trimmed":
                d2f = torch.where(good, gmin, torch.full_like(gmin, inf))
                n_pairs = torch.clamp(good.to(F32).sum(), min=1.0)
                srt = torch.sort(d2f).values
                cut = torch.clamp((cfg.trimmed_ratio * n_pairs).to(
                    torch.int64) - 1, 0, d2f.shape[0] - 1)
                good = good & (gmin <= _take(srt, cut))
            elif kind == "maxdist":
                good = good & (gmin <= float(np.float32(param * param)))
            elif kind == "median":
                # the mean of the two middle values for an even count
                d2f = torch.where(good, gmin, torch.full_like(gmin, inf))
                n_pairs = good.sum()
                srt = torch.sort(d2f).values
                last = d2f.shape[0] - 1
                lo = torch.clamp((n_pairs - 1) // 2, 0, last)
                hi = torch.clamp(n_pairs // 2, 0, last)
                med = 0.5 * (_take(srt, lo) + _take(srt, hi))
                good = good & (gmin <= float(np.float32(param * param))
                               * med)
        mine = (d2 <= gmin) & good
        j = torch.clamp(idx, min=0)
        q, qn = self.map_pos[j], self.map_nrm[j]
        for kind, param in cfg.outlier_filters:
            if kind == "normal":
                # the matched normal lives on the winning rank, so the
                # angle gate cuts this rank's own claims
                pdir = p / torch.clamp(torch.linalg.norm(
                    p, dim=1, keepdim=True), min=1e-9)
                cosang = torch.abs(torch.sum(pdir * qn, dim=1))
                mine = mine & (torch.acos(torch.clamp(cosang, 0.0, 1.0))
                               <= float(np.float32(param)))
        claims = reduce(mine.to(F32), SUM)
        w = torch.where(mine, 1.0 / torch.clamp(claims, min=1.0),
                        torch.zeros_like(claims))
        return q, qn, w, overlap, overflow

    def _point_to_point(self, p, q, w):
        """The pairs' float64 moments (one launch of ``ops/kabsch.py``'s
        pair reduction), summed over the ranks in one reduction, then the
        rigid increment and the rms from them (one launch)."""
        m = p2p_moments(p, q[:, None, :], w[:, None])
        return kabsch_from_moments(self.step._reduce(m, SUM), self.cfg.dim)

    def _point_to_plane(self, p, q, qn, w):
        dim = self.cfg.dim
        dof = self.eye_dof.shape[0]
        r = torch.sum(qn * (p - q), dim=1)
        if dim == 3:
            J = torch.cat([qn, torch.cross(p, qn, dim=1)], dim=1)
        else:
            c2 = p[:, 0] * qn[:, 1] - p[:, 1] * qn[:, 0]
            J = torch.cat([qn, c2[:, None]], dim=1)
        Jw = J * w[:, None]
        # JtJ, Jtr, the weight sum and the weighted sum of squares in one
        # reduction
        pack = torch.cat([(Jw.T @ J).reshape(-1), Jw.T @ r,
                          w.sum()[None], torch.sum(w * r * r)[None]])
        pack = self.step._reduce(pack, SUM)
        JtJ = pack[:dof * dof].reshape(dof, dof)
        Jtr = pack[dof * dof:dof * dof + dof]
        lam = 1e-3 * torch.trace(JtJ) / dof + 1e-6
        JtJ = JtJ + lam * self.eye_dof
        # solve_ex: the damped matrix is never singular, and the check of
        # linalg.solve would read on the host
        dx = -torch.linalg.solve_ex(JtJ, Jtr).result
        dT = se3.exp_se3(dx) if dim == 3 else se3.exp_se2(dx)
        rms = torch.sqrt(pack[-1] / torch.clamp(pack[-2], min=1e-9))
        return dT, rms


class _ShardedSolveGraph:
    """The sharded solve of one block capacity captured once as a CUDA
    graph under NCCL: the initial state (the reading's sort, the block's
    pack), then all ``max_iter`` iterations of :class:`_ShardedLoop` one
    after another (Identity: its one pass), their ``all_reduce``s recorded
    inside.  A replay runs the
    whole solve with no host read; the iterations after the stop are masked
    and change nothing.

    Not a WHILE node (``ops/graph_loop.py``): on four H100s (NCCL 2.28.9,
    CUDA 12.8) ending the capture of a WHILE body that holds an NCCL
    ``all_reduce`` fails with ``cudaErrorInvalidValue``, while the same
    collectives captured one after another replay correctly
    (``sharded_cards.py --probe``).

    The reading and the block are copied into static buffers before each
    replay, the solve index of the keyed draws through pinned memory; the
    outputs are copied out.  Warm-up and capture run on one side stream,
    after one eager iteration there (library handles, the kernels'
    libraries and NCCL's communicator exist before the capture)."""

    def __init__(self, step, read_pos, read_mask, map_pos, map_nrm, map_msk,
                 draws=None):
        self._inputs = [torch.empty_like(t) for t in (
            read_pos, read_mask, map_pos, map_nrm, map_msk)]
        self._solve = torch.zeros((), dtype=torch.int64,
                                  device=read_pos.device)
        self.loop = _ShardedLoop(step, *self._inputs, draws=draws,
                                 solve_index=self._solve)
        self._copy_in(read_pos, read_mask, map_pos, map_nrm, map_msk, 0)
        self._stream = torch.cuda.Stream()
        before = _counters()
        self._stream.wait_stream(torch.cuda.current_stream())
        loop = self.loop
        with torch.cuda.stream(self._stream):
            loop.start()
            if step.cfg.minimizer == "IdentityErrorMinimizer":
                loop.solve()
            else:
                loop.iteration(0)
        warm = _counters()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(self._stream), no_gc():
            self.graph.capture_begin(capture_error_mode="thread_local")
            try:
                loop.start()
                loop.solve()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(self._stream)
        captured = _counters()
        _restore_counters(before)  # warm-up and capture launched nothing
        self.replay = GraphReplay(tuple(
            (n1 - n0, {key: v - b0.get(key, 0) for key, v in b1.items()})
            for (n0, b0), (n1, b1) in zip(warm, captured)), 1)

    def _copy_in(self, *tensors_and_index):
        *tensors, index = tensors_and_index
        for dst, t in zip(self._inputs, tensors):
            dst.copy_(t)
        self._solve.copy_(torch.tensor(int(index), dtype=torch.int64
                                       ).pin_memory(), non_blocking=True)

    def run(self, read_pos, read_mask, map_pos, map_nrm, map_msk,
            solve_index: int = 0):
        """Copy in, replay, copy out: ``(T, overlap, iters, ihist,
        overflow)`` as fresh tensors; the wrappers' launch counts grow by
        one replay's."""
        self._copy_in(read_pos, read_mask, map_pos, map_nrm, map_msk,
                      solve_index)
        self.graph.replay()
        self.replay.count(1)
        return tuple(t.clone() for t in self.loop.outputs())

    def close(self) -> None:
        self.graph.reset()


def _host(tensors: List[torch.Tensor]):
    """Pinned host copies of device tensors, copied without blocking, with
    a CUDA event recorded behind them: ``(copies, event)``; on the CPU the
    tensors themselves and no event."""
    if not tensors or tensors[0].device.type != "cuda":
        return [t.detach() for t in tensors], None
    out = []
    for t in tensors:
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        out.append(h)
    ev = torch.cuda.Event()
    ev.record()
    return out, ev


class ShardedMapper:
    """Mapper over the sharded step: feed scans, read poses, export the map
    at the end (the only map-sized transfer besides the bounded window
    evictions).

    Rolling-window eviction to a CellManager, the DynamicPoints update,
    trajectory with exact-ns time stamps, keyframes, checkpoints.  Built
    from a :class:`ShardedMapConfig` or through the facade
    ``Mapper(config, mesh=mesh)`` (:meth:`from_mapper`).  ``device`` is
    where this rank's block lives (default the card; see
    :func:`shard_device`); ``seed`` / ``draw_source`` feed the random draws
    as the single-device Mapper's do.
    """

    HARVEST_EVERY = 8  # scans between reads of the count mirrors
    REBALANCE_MIN_POINTS = 8192  # below this, imbalance is noise
    REBALANCE_COOLDOWN = 8  # scans between rebalances
    PIPE_DEPTH = 3  # scans in flight on the card before one is harvested

    def __init__(self, mesh, cfg: Optional[ShardedMapConfig] = None,
                 cell_manager: Optional[CellManager] = None,
                 is_online: bool = False, device=None, seed: int = 0,
                 draw_source=None, draws: Optional[DrawSource] = None):
        self.cfg = cfg or ShardedMapConfig()
        # register and merge are separate calls in both modes, and the pose
        # is copied back between them (``get_pose`` waits for the solve
        # only); ``is_online`` is kept for the facade's sake
        self.is_online = bool(is_online)
        self.step = ShardedMapperStep(mesh, self.cfg, device=device)
        self.device = self.step.device
        rank = self.step.rank
        # replicated draws (reading and step filters), and the octree's
        # draws keyed by the rank
        self.draws = draws or DrawSource(seed, self.device, draw_source)
        self.shard_draws = DrawSource(seed + _RANK_SEED * (rank + 1),
                                      self.device, self.draws.source)
        self.state = None
        self.pose = None
        self._pose_mirror = None  # (pinned copy, event) of the last pose
        self.table_np = (np.arange(self.cfg.n_buckets, dtype=np.int32)
                         % self.step.n_shards)
        self.table = self._table_dev(self.table_np)
        self.balance: Optional[float] = None  # mean/max, from mirrors
        self._last_rebalance_scan = -self.REBALANCE_COOLDOWN
        self._last_t = np.float32(-np.inf)  # f32 s since the epoch
        self._last_pose = torch.eye(self.cfg.dim + 1, dtype=F32,
                                    device=self.device)
        self._counts_dev: Optional[torch.Tensor] = None  # [count, max]
        self._overlap = None
        self.last_iterations = None
        self.trajectory = Trajectory(self.cfg.dim)
        self.cell_manager = cell_manager or RAMCellManager()
        self.window = (_Window(self.cfg.dim, self.cfg.sensor_max_range)
                       if self.cfg.window_enabled else None)
        # (pose copies, event, merged, scan) per scan not yet harvested
        self._pending: "collections.deque" = collections.deque()
        self.inspector = None  # PerformanceInspector (set by from_mapper)
        self.overflow_totals = {"insert": 0, "halo": 0, "evict": 0}
        self._evict_pending = 0
        self._kf_cfg: Optional[Dict[str, float]] = None
        self._keyframes: List = []
        # running device totals of the insert and halo overflow
        self._of_dev = torch.zeros((2,), dtype=torch.int64,
                                   device=self.device)
        self._merges = 0  # merges so far (a host count: the decision is)
        self._merges_seen = 0
        self._local_events = 0  # host-side map edits (restore/evict/set)
        self._local_consumed = (0, 0)
        self._epoch_ns: Optional[int] = None
        self._scan_index = 0
        # host upper bound on the largest block's count, tightened from the
        # count mirrors every HARVEST_EVERY scans
        self._max_ub = 0
        self._since_harvest = 0
        # the host's waits for the card, by cause, and the scans they fell on
        self.waits = collections.Counter()
        self.read_log: List[Tuple[int, str]] = []

    def _table_dev(self, table_np: np.ndarray) -> torch.Tensor:
        return upload(table_np.astype(np.int64), self.device, torch.int64)

    def _read(self, cause: str, *tensors: torch.Tensor) -> List[np.ndarray]:
        """Host values of replicated device tensors: a non-blocking copy
        into pinned memory and a wait on its event, counted in
        ``waits[cause]``."""
        self.waits[cause] += 1
        self.read_log.append((self._scan_index, cause))
        host, ev = _host(list(tensors))
        if ev is not None:
            ev.synchronize()
        return [h.numpy() for h in host]

    # ----------------------------------------------------- YAML construction
    @classmethod
    def from_mapper(cls, mapper, mesh,
                    options: Optional[Dict[str, Any]] = None
                    ) -> "ShardedMapper":
        """The sharded backend of an already-configured ``Mapper``: the same
        reference config drives both backends.  ``options`` overrides the
        sharded-only knobs (cell_size, halo_capacity, ref_tile,
        evict_capacity, n_buckets, ...).  Raises on any plugin it cannot
        run rather than dropping its semantics."""
        icp = mapper.icp
        inspector = getattr(icp, "inspector", None)
        if inspector is not None and inspector.dump_dir is not None:
            raise NotImplementedError(
                "sharded backend: VTKFileInspector (per-iteration cloud "
                "dumps) is single-chip only; PerformanceInspector is "
                "supported")
        step_chain = getattr(icp, "reading_step_filters", None)
        step_fn = None
        if step_chain is not None and len(step_chain):
            for f in step_chain.filters:
                fname = getattr(f, "NAME", type(f).__name__)
                if fname in ("OctreeGridDataPointsFilter",
                             "VoxelGridDataPointsFilter") and int(
                        f.params.get("samplingMethod", 0)) == 2:
                    raise NotImplementedError(
                        "sharded backend: readingStepDataPointsFilters "
                        f"apply as a per-iteration mask; '{fname}' with "
                        "samplingMethod=2 replaces positions")
            step_fn = step_chain._apply_impl
        for f in icp.reading_filters.filters:
            fname = getattr(f, "NAME", type(f).__name__)
            if fname in ("OctreeGridDataPointsFilter",
                         "VoxelGridDataPointsFilter") and int(
                    f.params.get("samplingMethod", 0)) == 2:
                raise NotImplementedError(
                    "sharded backend: readingDataPointsFilters are applied "
                    f"as a registration mask only; '{fname}' with "
                    "samplingMethod=2 replaces positions with centroids "
                    "(geometry edit the mask cannot express)")
        if icp.minimizer not in ("PointToPlaneErrorMinimizer",
                                 "PointToPointErrorMinimizer",
                                 "IdentityErrorMinimizer"):
            raise NotImplementedError(
                f"sharded backend: errorMinimizer '{icp.minimizer}' "
                "unsupported (PointToPlane / PointToPoint / Identity)")
        outliers = tuple(getattr(icp, "outlier_filters", ()))

        kw: Dict[str, Any] = dict(
            dim=mapper.dim,
            minimizer=icp.minimizer,
            max_iter=icp.max_iter,
            match_max_dist=float(icp.match_max_dist),
            outlier_filters=outliers,
            step_filter=step_fn,
            diff_checker=icp.diff_checker,
            sensor_max_range=mapper.map.get_sensor_max_range(),
            window_enabled=True,
            update_condition=mapper.map_update_condition,
            update_value={
                "distance": mapper.map_update_distance,
                "overlap": mapper.map_update_overlap,
                "delay": mapper.map_update_delay,
            }[mapper.map_update_condition],
            voxel_size=0.0,
            min_dist_new_point=0.0,
            cut_threshold=None,
            dynamic_points=None,
            bound_checker=icp.bound_checker,
            inspect=inspector is not None,
        )

        seen_dp = False
        for mod in mapper.map.modules:
            name = getattr(mod, "NAME", type(mod).__name__)
            if name == "PointDistanceMapperModule":
                kw["min_dist_new_point"] = float(
                    mod.params["minDistNewPoint"])
            elif name == "OctreeMapperModule":
                kw["voxel_size"] = float(mod.params["maxSizeByNode"])
                kw["sampling_method"] = int(mod.params["samplingMethod"])
                kw["max_point_by_node"] = int(mod.params["maxPointByNode"])
            elif name == "DynamicPointsMapperModule":
                if seen_dp is False and kw["voxel_size"] != 0.0:
                    raise NotImplementedError(
                        "sharded backend: DynamicPointsMapperModule must "
                        "precede OctreeMapperModule (the in-step update "
                        "runs before the insert)")
                kw["dynamic_points"] = dict(mod.params)
                seen_dp = True
            else:
                raise NotImplementedError(
                    f"sharded backend: mapper module '{name}' unsupported")

        for f in mapper.post_filters.filters:
            name = getattr(f, "NAME", type(f).__name__)
            if name == "SurfaceNormalDataPointsFilter":
                kw["normal_min_knn"] = int(f.params["knn"])
                max_dist = float(f.params["maxDist"])
                if not np.isfinite(max_dist):
                    raise NotImplementedError(
                        "sharded backend: SurfaceNormal needs a finite "
                        "maxDist (halo radius-PCA engine)")
                kw["normal_radius"] = max_dist
            elif name == "CutAtDescriptorThresholdDataPointsFilter":
                if f.params.get("descName",
                                "probabilityDynamic") != "probabilityDynamic":
                    raise NotImplementedError(
                        "sharded backend: CutAtDescriptorThreshold supports "
                        "descName=probabilityDynamic only")
                if not int(f.params.get("useLargerThan", 1)):
                    raise NotImplementedError(
                        "sharded backend: CutAtDescriptorThreshold supports "
                        "useLargerThan=1 only")
                kw["cut_threshold"] = float(f.params["threshold"])
            else:
                raise NotImplementedError(
                    f"sharded backend: post filter '{name}' unsupported")

        kw.update(options or {})
        inst = cls(mesh, ShardedMapConfig(**kw),
                   cell_manager=mapper.map.cell_manager,
                   is_online=mapper.is_online, device=mapper.device,
                   seed=mapper.seed, draws=mapper.draws)
        inst.inspector = inspector
        return inst

    def set_map(self, cloud) -> None:
        """Replace the map: spilled cells are cleared and the window
        re-arms, so the next scan re-partitions the new map."""
        if isinstance(cloud, PointBatch):
            batch = cloud.to(self.device)
        else:
            desc = {k: np.asarray(v) for k, v in cloud.items()
                    if k != "positions"}
            batch = PointBatch.from_numpy(
                np.asarray(cloud["positions"])[:, : self.cfg.dim], desc,
                device=self.device)
        bpos = np.asarray(batch.to_numpy()["positions"])
        hist = np.bincount(self.step.bucket_of(bpos),
                           minlength=self.cfg.n_buckets)
        self.table_np = greedy_table(hist, self.step.n_shards)
        self.table = self._table_dev(self.table_np)
        self.state = self.step.init_state(batch, self.table_np)
        self._set_counts(self.step._counts(self.state["msk"]))
        self._overlap = None
        home = self.step.home_of(bpos, self.table_np)
        self._max_ub = int(np.bincount(
            home, minlength=self.step.n_shards).max()) if home.size else 0
        self._since_harvest = 0
        self._pending.clear()
        self.cell_manager.clear_all_cells()
        self._local_events += 1  # imported map = new local content
        if self.window is not None:
            self.window.w = None  # re-arm the first-pose partition

    # ------------------------------------------------------------ capacity
    def _set_counts(self, m: Dict[str, torch.Tensor]) -> None:
        self._counts_dev = torch.stack([m["count"], m["max_shard_count"]])

    def _resize(self, new_cap: int):
        """Grow (pad) or shrink (compact, then slice) this rank's block;
        every rank takes the same ``new_cap`` (the decision comes from
        reduced counts)."""
        cap = self.state["pos"].shape[0]
        if new_cap == cap:
            return
        if new_cap < cap:
            self.state, m = self.step.compact(self.state)
            self._set_counts(m)
            self._max_ub = int(self._read("shrink", m["max_shard_count"])[0])
            self._since_harvest = 0
            new_cap = max(new_cap, _round_up(self._max_ub + 1, 1024))
            if new_cap >= cap:
                return
        grow = new_cap - cap
        if grow > 0:
            self.state = {k: torch.cat([v, v.new_zeros(
                (grow,) + tuple(v.shape[1:]))]) for k, v in
                self.state.items()}
        else:
            self.state = {k: v[:new_cap].contiguous()
                          for k, v in self.state.items()}

    def _ensure_capacity(self, n_new: int):
        """Grow the blocks before the worst case (every new point landing on
        one rank) could overflow; shrink when eviction left them mostly
        empty.  The count mirrors are read every HARVEST_EVERY scans, and
        first when a grow looks due, so that provisional slack never grows
        the blocks."""
        def harvest():
            if self._counts_dev is not None and self._since_harvest > 0:
                count, mx = (int(v) for v in self._read(
                    "capacity", self._counts_dev)[0])
                self._max_ub = mx
                self._since_harvest = 0
                if mx > 0:
                    self.balance = (count / self.step.n_shards) / mx
                    self._maybe_rebalance(count)

        if self._since_harvest >= self.HARVEST_EVERY:
            harvest()
        cap = self.state["pos"].shape[0]
        if self._max_ub + n_new > cap:
            harvest()
        need = self._max_ub + n_new
        if need > cap:
            self._resize(_round_up(max(need + n_new, cap * 3 // 2), 1024))
        elif self._since_harvest == 0 and cap > 4096 \
                and (self._max_ub + n_new) * 3 < cap:
            self._resize(_round_up((self._max_ub + n_new) * 2, 1024))

    # ----------------------------------------------------------- rebalance
    def _maybe_rebalance(self, count: int):
        """When the harvested mean/max balance drops below
        ``rebalance_below``, rebuild the table from the measured bucket
        histogram and move the reassigned buckets' points (one gather)."""
        if (self.balance is None
                or self.balance >= self.cfg.rebalance_below
                or count < self.REBALANCE_MIN_POINTS
                or self.step.n_shards == 1
                or self._scan_index - self._last_rebalance_scan
                < self.REBALANCE_COOLDOWN):
            return
        self._last_rebalance_scan = self._scan_index
        weights = np.asarray(self._read(
            "rebalance", self.step.bucket_hist(self.state))[0], np.int64)
        new_table, moved_off = incremental_moves(
            weights, self.table_np, self.step.n_shards,
            self.cfg.rebalance_target)
        if moved_off.sum() == 0:
            return
        S = self.step.n_shards
        new_loads = np.bincount(new_table, weights=weights, minlength=S)
        slack = self.HARVEST_EVERY * 2048  # points inserted since the hist
        self._ensure_capacity(int(new_loads.max() - self._max_ub) + slack
                              if new_loads.max() > self._max_ub else slack)
        move_cap = bucket_capacity(int(moved_off.max()) + slack)
        self.state, m = self.step.rebalance(
            self.state, self._table_dev(new_table), move_cap)
        self._set_counts(m)
        ins, stayed, count, mx = (int(v) for v in self._read(
            "rebalance", torch.stack([m["insert_overflow"], m["stayed_home"],
                                      m["count"], m["max_shard_count"]]))[0])
        if ins > 0:
            raise AssertionError(
                "sharded rebalance destination overflow despite "
                f"ensure_capacity: {ins} points")
        self.overflow_totals["rebalance"] = (
            self.overflow_totals.get("rebalance", 0) + stayed)
        self.table_np = new_table
        self.table = self._table_dev(new_table)
        self._max_ub = mx
        self._since_harvest = 0
        self.balance = (count / S) / mx if mx else None

    # ------------------------------------------------------------- window
    def _advance_window(self, pose_np: np.ndarray, force: bool = False):
        """Shift the rolling window to ``pose_np``; when edges moved, evict
        out-of-box points to the CellManager (gathered to every rank, so
        every rank's store holds the same cells) and restore saved cells
        that re-entered."""
        if self.window is None:
            return
        changed = self.window.advance(pose_np)
        # while the last eviction overflowed its buffer, keep evicting at
        # every scan until the map is window-clean
        if not (changed or force or self._evict_pending > 0):
            return
        lo, hi = self.window.box()
        self._local_events += 1
        self.state, bufs, m = self.step.evict(
            self.state, upload(lo, self.device), upload(hi, self.device))
        self._set_counts(m)
        evicted, ev_of, _, mx = (int(v) for v in self._read(
            "window", torch.stack([m["evicted"], m["evict_overflow"],
                                   m["count"], m["max_shard_count"]]))[0])
        self.overflow_totals["evict"] += ev_of
        self._evict_pending = ev_of
        self._max_ub = mx
        self._since_harvest = 0
        if evicted > 0:
            g = {k: self.step._gather(v) for k, v in bufs.items()}
            D = self.cfg.dim
            host = dict(zip(g, self._read("window", *g.values())))
            valid = host["valid"].reshape(-1)
            evict = {"positions": host["pos"].reshape(-1, D)[valid],
                     "normals": host["nrm"].reshape(-1, D)[valid],
                     "probabilityDynamic":
                         host["prob"].reshape(-1)[valid][:, None]}
            bin_points_to_cells(evict, self.cell_manager, D)
        data, _ = collect_cells_in_bounds(
            self.cell_manager, self.window.grid_bounds(), self.cfg.dim,
            remove=True)
        if data is not None:
            self._insert_points(data)

    def _insert_points(self, data: Dict[str, np.ndarray]):
        """Insert host points (the restore path), each rank taking its
        homed subset; the inputs are the same on every rank."""
        pos = np.asarray(data["positions"], np.float32)[:, : self.cfg.dim]
        n = pos.shape[0]
        if n == 0:
            return
        nrm = np.asarray(data.get(
            "normals", np.zeros_like(pos)), np.float32)[:, : self.cfg.dim]
        prob = data.get("probabilityDynamic")
        prob = (np.asarray(prob, np.float32).reshape(n, -1)[:, 0]
                if prob is not None else np.zeros(n, np.float32))
        cap = bucket_capacity(n)
        pad = cap - n
        pos = np.pad(pos, ((0, pad), (0, 0)))
        nrm = np.pad(nrm, ((0, pad), (0, 0)))
        prob = np.pad(prob, (0, pad))
        valid = np.zeros(cap, bool)
        valid[:n] = True
        self._ensure_capacity(n)
        dev = self.device
        self.state, m = self.step.insert(
            self.state, self.table, upload(pos, dev), upload(nrm, dev),
            upload(prob, dev), upload(valid, dev, torch.bool))
        self._set_counts(m)
        ins, mx = (int(v) for v in self._read(
            "window", torch.stack([m["insert_overflow"],
                                   m["max_shard_count"]]))[0])
        if ins > 0:
            raise AssertionError(
                f"sharded restore overflow despite ensure_capacity: {ins} "
                "points")
        self._max_ub = mx
        self._since_harvest = 0

    # ------------------------------------------------------------ hot path
    def bootstrap(self, scan: PointBatch, pose: np.ndarray,
                  capacity: Optional[int] = None):
        """The first scan becomes the map (one host pass: the table is built
        from its measured bucket weights)."""
        d = self.cfg.dim
        pose = np.asarray(pose, np.float32)
        scan = scan.to(self.device)
        wpos = (scan.positions.cpu().numpy() @ pose[:d, :d].T
                + pose[:d, d]).astype(np.float32)
        world = PointBatch(upload(wpos, self.device), scan.mask,
                           dict(scan.descriptors))
        if "normals" not in world.descriptors:
            # the point-to-plane solve needs map normals before the first
            # merge computes them
            cnt, _, cov, _ = radius_pca(
                world.positions, world.positions, world.mask, world.mask,
                self.cfg.normal_radius, q_tile=1024,
                W=2048 if self.cfg.normal_radius <= 1.0 else 4096)
            eig = sym_eig3_smallest if d == 3 else sym_eig2_smallest
            _, normal = eig(cov)
            world = world.with_descriptor("normals", torch.where(
                (cnt >= self.cfg.normal_min_knn)[:, None], normal,
                torch.zeros_like(normal)))
        wpos = world.to_numpy()["positions"]
        hist = np.bincount(self.step.bucket_of(wpos),
                           minlength=self.cfg.n_buckets)
        self.table_np = greedy_table(hist, self.step.n_shards)
        self.table = self._table_dev(self.table_np)
        self.state = self.step.init_state(world, self.table_np,
                                          capacity=capacity)
        self._set_counts(self.step._counts(self.state["msk"]))
        home = self.step.home_of(wpos, self.table_np)
        self._max_ub = int(np.bincount(home,
                                       minlength=self.step.n_shards).max())
        self.pose = pose
        if self.window is not None:
            self.window.first(pose)
            # trim a restored map to the window box (the reference's
            # first-update full partition)
            self._advance_window(pose, force=True)

    def process_input(self, scan: PointBatch, est_pose: np.ndarray,
                      stamp_s: Optional[float] = None,
                      is_mapping: bool = True,
                      timestamp_ns: Optional[int] = None,
                      read_mask: Optional[torch.Tensor] = None,
                      scan_valid_hint: Optional[int] = None):
        """One scan (sensor frame) and its pose prior.  ``stamp_s`` (float
        seconds) or ``timestamp_ns`` (exact integer ns) must be given; the
        trajectory records exact ns, the delay gate compares f32 seconds
        since the session's epoch, as the JAX step does."""
        if timestamp_ns is None:
            timestamp_ns = int(round(float(stamp_s or 0.0) * 1e9))
        if self._epoch_ns is None:
            self._epoch_ns = int(timestamp_ns)
        stamp_rel = np.float32((int(timestamp_ns) - self._epoch_ns) * 1e-9)
        est_pose = np.asarray(est_pose, np.float32)
        scan = scan.to(self.device)

        if self.state is None:
            self.bootstrap(scan, est_pose)
            self._last_t = stamp_rel
            self.trajectory.add_pose(est_pose, timestamp_ns)
            self._scan_index += 1
            if self._kf_cfg is not None:
                self._maybe_keyframe(scan, est_pose)  # a map update
            return

        if self.window is not None and self.window.w is None:
            # set_map() re-armed the first-pose partition
            self.window.first(est_pose)
            self._advance_window(est_pose, force=True)
        # the window and the keyframes follow the corrected poses of earlier
        # scans, at a lag set by the scan count alone
        self._harvest_pending()
        # a prior that has already moved window edges past the hysteresis
        # (a jump) restores saved cells before this scan's merge
        if self.window is not None and self.window.w is not None:
            self._advance_window(est_pose)

        n_scan = int(min(scan_valid_hint, scan.capacity)
                     if scan_valid_hint else scan.capacity)
        self._ensure_capacity(n_scan)
        prob = scan.descriptors.get("probabilityDynamic")
        prob = (prob[:, 0] if prob is not None
                else torch.zeros(scan.mask.shape, dtype=F32,
                                 device=self.device))
        if read_mask is None:
            read_mask = scan.mask
        est_t = upload(est_pose, self.device)
        reg = self.step.register(self.state, scan.positions,
                                 read_mask.to(self.device), est_t,
                                 self.draws)
        # the pose's host copy is queued before the merge: a reader of the
        # pose waits for the solve, not for the merge
        host, ev = _host([reg["pose"]])
        self._pose_mirror = (host[0], ev)
        do_merge = self._merge_decision(reg, stamp_rel, is_mapping)
        if do_merge:
            self.state, mg = self.step.merge(
                self.state, self.table, scan.positions, scan.mask, prob,
                reg["correction"], est_t, self.shard_draws)
            self._set_counts(mg)
            self._of_dev = self._of_dev + torch.stack(
                [mg["insert_overflow"], mg["halo_overflow"]])
            self._merges += 1
            self._last_t = stamp_rel
            self._last_pose = reg["pose"]
        if self.cfg.bound_checker is not None or self.inspector is not None:
            self._check_solve(reg, est_pose)
        self._max_ub += n_scan  # provisional until the next harvest
        self._since_harvest += 1
        self._scan_index += 1
        self.pose = reg["pose"]
        self._overlap = reg["overlap"]
        self.last_iterations = reg["iters"]
        self._pending.append((host[0], ev, do_merge,
                              scan if self._kf_cfg is not None else None))
        self.trajectory.add_pose(reg["pose"], timestamp_ns)

    def _merge_decision(self, reg, stamp_rel, is_mapping: bool) -> bool:
        """The update condition, taken alike on every rank: under ``delay``
        from host time stamps (f32 arithmetic, as the JAX step's), under
        ``distance`` / ``overlap`` from one read of the replicated flag."""
        cfg = self.cfg
        if not is_mapping:
            return False
        if cfg.update_condition == "delay":
            return bool(np.float32(stamp_rel - self._last_t)
                        > np.float32(cfg.update_value))
        if cfg.update_condition == "overlap":
            flag = reg["overlap"] < cfg.update_value
        else:
            d = cfg.dim
            flag = torch.linalg.norm(reg["pose"][:d, d]
                                     - self._last_pose[:d, d]) \
                > cfg.update_value
        return bool(self._read("merge_decision", flag)[0])

    def _check_solve(self, reg, est_pose):
        """The inspector's history and the bound checker's throw need this
        scan's solve now: one read (lpm's inspector and throwing checker
        take the same trade)."""
        pose, iters, ihist = self._read("inspect", reg["pose"], reg["iters"],
                                        reg["ihist"])
        if self.inspector is not None and self.cfg.inspect:
            for i in range(max(1, int(iters))):
                self.inspector.record(i + 1, float(ihist[i, 0]),
                                      float(ihist[i, 1]), None)
        if self.cfg.bound_checker is not None:
            d = self.cfg.dim
            T_h = (np.asarray(pose, np.float64)
                   @ np.linalg.inv(np.asarray(est_pose, np.float64)))
            max_rot, max_trans = self.cfg.bound_checker
            if (_rot_angle_np(T_h[:d, :d].astype(np.float32)) > max_rot
                    or float(np.linalg.norm(T_h[:d, d])) > max_trans):
                raise RuntimeError(
                    "BoundTransformationChecker: transformation beyond "
                    f"bound (maxRotationNorm={max_rot}, "
                    f"maxTranslationNorm={max_trans}) — lpm aborts "
                    "registration here")

    def _harvest_pending(self, force: bool = False):
        """Fold finished scans' poses into the rolling window and the
        keyframe store.  Which scans are folded depends on the scan count
        alone (the same on every rank): on the CPU every pending scan, on
        the card the scans more than ``PIPE_DEPTH`` behind, waiting on
        their events; ``force`` (drain) folds them all."""
        while self._pending:
            if self.window is None and self._kf_cfg is None:
                self._pending.clear()
                return
            pose_h, ev, merged, scan = self._pending[0]
            if (ev is not None and not force
                    and len(self._pending) <= self.PIPE_DEPTH):
                return
            self._pending.popleft()
            if ev is not None:
                if not ev.query():
                    self.waits["pipeline_depth"] += 1
                    self.read_log.append((self._scan_index,
                                          "pipeline_depth"))
                ev.synchronize()
            pose_np = pose_h.numpy().copy()
            if self._kf_cfg is not None and merged:
                self._maybe_keyframe(scan, pose_np)
            if self.window is not None:
                self._advance_window(pose_np)

    # ------------------------------------------------------------ keyframes
    def enable_keyframes(self, min_distance: float = 1.0,
                         max_keyframes: int = 256):
        """Record (sensor-frame scan, corrected pose) keyframes at merges,
        the store ``refine_trajectory`` reads."""
        self._kf_cfg = {"min_distance": float(min_distance),
                        "max_keyframes": int(max_keyframes)}
        self._keyframes = []

    def _maybe_keyframe(self, scan: PointBatch, pose: np.ndarray):
        from ..slam.pose_graph import keyframe_insert
        keyframe_insert(self._keyframes, self._kf_cfg, scan.positions,
                        scan.mask, np.asarray(pose, np.float32),
                        self.cfg.dim)

    def drain(self) -> Dict[str, Any]:
        """Harvest everything pending and read the mirrors (a sync point)."""
        self._harvest_pending(force=True)
        if self._overlap is None:
            return {}  # no scan registered yet
        vals = self._read("drain", torch.cat([self._counts_dev,
                                              self._of_dev]))[0]
        count, mx, ins, halo = (int(v) for v in vals)
        # the mirrors are running totals: assignment is idempotent
        self.overflow_totals["insert"] = ins
        self.overflow_totals["halo"] = halo
        self._merges_seen = self._merges
        if self._since_harvest > 0:
            self._max_ub = mx
            self._since_harvest = 0
            if mx > 0:
                self.balance = (count / self.step.n_shards) / mx
                self._maybe_rebalance(count)
        out = {"count": count, "max_shard_count": mx,
               "insert_overflow": ins, "halo_overflow": halo,
               "merges_total": self._merges}
        out["overlap"] = float(self._read("drain", self._overlap)[0])
        return out

    # ----------------------------------------------------------- accessors
    def shutdown(self) -> None:
        """Drain and free the solve graphs (before the process group is
        destroyed: NCCL waits for the graphs that captured its
        collectives); the mapper maps on, capturing anew, if fed again."""
        self.drain()
        self.step.close()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def get_pose(self) -> np.ndarray:
        """The latest corrected pose; for a scan on the card this waits for
        its solve (not for its merge)."""
        if isinstance(self.pose, torch.Tensor):
            host, ev = self._pose_mirror
            if ev is not None:
                ev.synchronize()
            return host.numpy().copy()
        return np.asarray(self.pose)

    def capacity(self) -> int:
        """This rank's block capacity (the same on every rank)."""
        return 0 if self.state is None else int(self.state["pos"].shape[0])

    def get_new_local_point_cloud(self) -> Optional[Dict[str, np.ndarray]]:
        """Consume-once export of the device-resident (window) map: the
        gathered local map when a merge or a window move changed it since
        the last call, else ``None``.  A map-sized gather."""
        self.drain()
        now = (self._merges_seen, self._local_events)
        if now == self._local_consumed:
            return None
        self._local_consumed = now
        return self.get_map(include_evicted=False)

    def get_map(self, include_evicted: bool = True) -> Dict[str, np.ndarray]:
        """Every rank's block gathered to the host, on every rank (the end
        of a run), with the evicted cells by default."""
        st = self.step.gather_state(self.state)
        D = self.cfg.dim
        msk = st["msk"].reshape(-1)
        out = {
            "positions": st["pos"].reshape(-1, D)[msk],
            "normals": st["nrm"].reshape(-1, D)[msk],
            "probabilityDynamic": st["prob"].reshape(-1)[msk][:, None],
        }
        if include_evicted:
            parts = [out]
            for cid in self.cell_manager.get_all_cell_ids():
                cell = self.cell_manager.retrieve_cell(cid)
                if cell is None or cell["positions"].shape[0] == 0:
                    continue
                n = cell["positions"].shape[0]
                parts.append({
                    "positions":
                        np.asarray(cell["positions"], np.float32)[:, :D],
                    "normals": np.asarray(
                        cell.get("normals", np.zeros((n, D))),
                        np.float32)[:, :D],
                    "probabilityDynamic": np.asarray(
                        cell.get("probabilityDynamic", np.zeros((n, 1))),
                        np.float32).reshape(n, -1)[:, :1],
                })
            out = {k: np.concatenate([p[k] for p in parts])
                   for k in ("positions", "normals", "probabilityDynamic")}
        return out

    # ---------------------------------------------------------- checkpoint
    def save_checkpoint(self, path: str) -> None:
        """The exact sharded state in the JAX package's ``.npz`` layout (raw
        ``[S, cap, ...]`` blocks, spilled cells, pose, trajectory in exact
        ns, update-condition state); rank 0 writes, then every rank passes a
        barrier."""
        self.drain()
        st = self.step.gather_state(self.state)
        arrays = {f"state_{k}": np.asarray(v) for k, v in st.items()}
        arrays["pose"] = self.get_pose()
        arrays["last_pose"] = self._read("checkpoint", self._last_pose)[0]
        arrays["last_t"] = np.asarray([float(self._last_t)], np.float64)
        # int64-min for "no epoch yet": epoch 0 is a valid epoch
        arrays["epoch_ns"] = np.asarray(
            [np.iinfo(np.int64).min if self._epoch_ns is None
             else self._epoch_ns], np.int64)
        arrays["scan_index"] = np.asarray([self._scan_index], np.int64)
        arrays["bucket_table"] = self.table_np
        arrays["traj_poses"] = (np.stack(self.trajectory.poses)
                                if len(self.trajectory) else
                                np.zeros((0, self.cfg.dim + 1,
                                          self.cfg.dim + 1), np.float32))
        arrays["traj_stamps"] = np.asarray(self.trajectory.timestamps,
                                           np.int64)
        if self.window is not None and self.window.w is not None:
            arrays["window_w"] = np.asarray(self.window.w, np.int64)
        for cid in self.cell_manager.get_all_cell_ids():
            cell = self.cell_manager.retrieve_cell(cid)
            for name, v in cell.items():
                arrays[f"cell|{cid}|{name}"] = v
        if self.step.rank == 0:
            np.savez_compressed(path, **arrays)
        dist.barrier(group=self.step.group)

    @classmethod
    def load_checkpoint(cls, path: str, mesh,
                        cfg: Optional[ShardedMapConfig] = None,
                        cell_manager: Optional[CellManager] = None,
                        **kw) -> "ShardedMapper":
        """Rebuild a ShardedMapper from a checkpoint (this package's or the
        JAX package's): this rank takes block ``rank`` (the same number of
        ranks as blocks is required), so later poses continue the saved
        run.  ``kw`` goes to the constructor (``device``, ``seed``, ...)."""
        data = np.load(path)
        sm = cls(mesh, cfg, cell_manager=cell_manager, **kw)
        blocks = {k[len("state_"):]: data[k] for k in data.files
                  if k.startswith("state_")}
        S = blocks["pos"].shape[0]
        if S != sm.step.n_shards:
            raise ValueError(
                f"checkpoint has {S} shards, mesh has {sm.step.n_shards}")
        if "bucket_table" in data.files:
            sm.table_np = np.asarray(data["bucket_table"], np.int32)
            sm.table = sm._table_dev(sm.table_np)
        sm.state = sm.step.put_state(blocks)
        sm._set_counts(sm.step._counts(sm.state["msk"]))
        sm._max_ub = int(blocks["msk"].sum(axis=1).max())
        sm.pose = np.asarray(data["pose"], np.float32)
        sm._last_pose = upload(np.asarray(data["last_pose"], np.float32),
                               sm.device)
        sm._last_t = np.float32(float(data["last_t"][0]))
        raw_epoch = int(data["epoch_ns"][0])
        sm._epoch_ns = (None if raw_epoch == np.iinfo(np.int64).min
                        else raw_epoch)
        sm._scan_index = int(data["scan_index"][0])
        for pose, stamp in zip(data["traj_poses"], data["traj_stamps"]):
            sm.trajectory.add_pose(pose, int(stamp))
        if "window_w" in data.files and sm.window is not None:
            sm.window.w = [int(v) for v in data["window_w"]]
        cells: Dict[str, Dict[str, np.ndarray]] = {}
        for k in data.files:
            if k.startswith("cell|"):
                _, cid, name = k.split("|", 2)
                cells.setdefault(cid, {})[name] = data[k]
        for cid, cell in cells.items():
            sm.cell_manager.save_cell(cid, cell)
        return sm
