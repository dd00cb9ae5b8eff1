"""Map: local point cloud, scan-merge pipeline, rolling-window cell logic.

Parity with reference ``Map.{h,cpp}``:

  - local cloud ownership + merge pipeline: first scan goes through
    ``modules[0].create_map`` then the rest update; afterwards every module
    updates; post filters run in the *sensor frame*; finally the ICP engine
    gets the new map.
  - rolling window of 20 m cells around the robot: per-axis hysteresis of 2
    cells, slabs of cells padded by BUFFER_SIZE=2 load/unload as the robot
    moves; evicted cells go to a CellManager keyed ``"row_col_aisle"``.
  - global export/import.

The local cloud is a fixed-capacity ``PointBatch`` on the map's device;
merging, post-filtering and the transforms are tensor passes there; cell
binning and eviction are host-side numpy (IO and bookkeeping).

Window events: ``update_pose(pose, defer=True)`` advances the window and
returns its load/unload events instead of applying them (the pipelined
Mapper applies them at its next sync point, ``_apply_update``); online
(``is_online=True``) the events of an immediate ``update_pose`` go to a
background cell-update thread (reference ``Map.cpp:29-57``).  A lock guards
the local cloud against that thread.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from . import se3
from .draws import DrawSource, resolve_device
from .points import PointBatch, bucket_capacity, concatenate, insert
from .cell_manager import CellManager, RAMCellManager, HardDriveCellManager

__all__ = ["Map", "bin_points_to_cells", "collect_cells_in_bounds",
           "merge_scan", "apply_post_filters"]

CELL_SIZE = 20.0  # m (reference Map.h)
BUFFER_SIZE = 2  # cells (reference Map.h)
DEFAULT_SENSOR_MAX_RANGE = 200.0  # m (reference Map.h)

# grid sentinels (reference Map.cpp)
_MIN_GRID = -(2 ** 31)
_MAX_GRID = 2 ** 31 - 2


def _to_inferior_grid(w: float, rng: float) -> int:
    return int(np.ceil((w - rng) / CELL_SIZE - 1.0))


def _to_superior_grid(w: float, rng: float) -> int:
    return int(np.floor((w + rng) / CELL_SIZE))


def bin_points_to_cells(evict: Dict[str, np.ndarray], cell_manager,
                        dim: int) -> None:
    """Bin evicted points into 20 m cells and save each to the cell manager
    (vectorized form of the reference's per-cell growable binning).

    A save MERGES with existing saved content; loads remove the saved copy
    (``Map._load_cells``), so a re-save never finds stale content and the
    merge is equivalent to the reference's ``saveCell`` overwrite."""
    ev_pos = evict["positions"]
    if ev_pos.shape[0] == 0:
        return
    cell_idx = np.floor(ev_pos / CELL_SIZE).astype(np.int64)
    if dim == 2:
        cell_idx = np.concatenate(
            [cell_idx, np.zeros((cell_idx.shape[0], 1), np.int64)], axis=1)
    order = np.lexsort((cell_idx[:, 2], cell_idx[:, 1], cell_idx[:, 0]))
    sorted_cells = cell_idx[order]
    boundaries = np.nonzero(
        np.any(np.diff(sorted_cells, axis=0) != 0, axis=1))[0] + 1
    starts = np.concatenate([[0], boundaries])
    ends = np.concatenate([boundaries, [ev_pos.shape[0]]])
    for s, e in zip(starts, ends):
        i, j, k = (int(v) for v in sorted_cells[s])
        rows = order[s:e]
        cell = {name: arr[rows] for name, arr in evict.items()}
        cid = f"{i}_{j}_{k}"
        existing = cell_manager.retrieve_cell(cid)
        if existing is not None and existing["positions"].shape[0] > 0:
            merged = {}
            for name in cell:
                if name in existing:
                    merged[name] = np.concatenate(
                        [existing[name], cell[name]])
                else:
                    merged[name] = cell[name]
            cell = merged
        cell_manager.save_cell(cid, cell)


def _stack_cells(chunks: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Concatenate host cell dicts; descriptor sets are unioned, channels a
    chunk lacks zero-fill."""
    names = sorted({n for c in chunks for n in c})
    out = {}
    for n in names:
        parts = []
        for c in chunks:
            if n in c:
                a = c[n]
                parts.append(a if a.ndim > 1 else a[:, None])
            else:
                kdim = next(
                    (cc[n].shape[1] if cc[n].ndim > 1 else 1)
                    for cc in chunks if n in cc)
                parts.append(
                    np.zeros((c["positions"].shape[0], kdim), np.float32))
        out[n] = np.concatenate(parts)
    return out


def collect_cells_in_bounds(cell_manager, bounds, dim: int,
                            remove: bool = False):
    """Gather every saved cell whose grid coordinates fall inside
    ``bounds = (sr, er, sc, ec, sa, ea)`` into one host dict.  With
    ``remove=True`` the collected cells are deleted from the manager.
    Returns ``(data | None, ids)``."""
    sr, er, sc, ec, sa, ea = bounds
    chunks, ids = [], []
    for cid in list(cell_manager.get_all_cell_ids()):
        i, j, k = (int(v) for v in cid.split("_"))
        if sr <= i <= er and sc <= j <= ec and (dim == 2 or sa <= k <= ea):
            cell = cell_manager.retrieve_cell(cid)
            if cell is not None and cell["positions"].shape[0] > 0:
                chunks.append(cell)
            ids.append(cid)
            if remove:
                cell_manager.remove_cell(cid)
    if not chunks:
        return None, ids
    return _stack_cells(chunks), ids


# ------------------------------------------------------------ merge pipeline

def apply_post_filters(local: PointBatch, pose: torch.Tensor, post_filters,
                       draws: Optional[DrawSource], timer=None) -> PointBatch:
    """Post filters run in the sensor frame (reference ``Map.cpp:523-525``).
    ``timer`` (a ``fused.PhaseTimer``) gets one phase per filter."""
    if post_filters is None or not len(post_filters):
        return local
    local = se3.apply(se3.inverse(pose), local)
    if timer is None:
        local = post_filters._apply_impl(local, draws)
    else:
        for f in post_filters.filters:
            with timer.phase(f.NAME, local.device):
                local = f.apply(local, draws)
    return se3.apply(pose, local)


def merge_scan(modules, scan: PointBatch, local: PointBatch,
               pose: torch.Tensor, post_filters,
               draws: Optional[DrawSource], create: bool = False
               ) -> PointBatch:
    """The merge pipeline at fixed capacity: the module chain, then the
    sensor-frame post filters.  ``create=True`` is the first scan
    (reference ``Map.cpp:505-515``): ``modules[0].create_map`` fills the
    pre-sized empty ``local``, the remaining modules update."""
    mods = list(modules)
    if create:
        local = insert(local, mods[0].create_map(scan, pose, draws))
        mods = mods[1:]
    for m in mods:
        local = m.update_map(scan, local, pose, draws)
    return apply_post_filters(local, pose, post_filters, draws)


class Map:
    def __init__(self, is_3d: bool, is_online: bool,
                 save_cells_on_hard_drive: bool, icp, device="cuda"):
        self.is_3d = is_3d
        self.dim = 3 if is_3d else 2
        self.is_online = is_online
        self.icp = icp
        self.device = resolve_device(device)
        self.sensor_max_range = DEFAULT_SENSOR_MAX_RANGE
        self.cell_manager: CellManager = (
            HardDriveCellManager() if save_cells_on_hard_drive else RAMCellManager())
        self.modules: List = []
        self.local: Optional[PointBatch] = None
        self._known_count: Optional[int] = None  # host mirror of local.count
        self.loaded_cell_ids: set = set()
        self.first_pose_update = True
        self.new_local_available = False
        self._window = None  # [inf_r, sup_r, inf_c, sup_c, inf_a, sup_a]
        self._lock = threading.RLock()
        self._update_queue: "queue.Queue" = queue.Queue()
        self._update_thread: Optional[threading.Thread] = None
        self._thread_running = False
        if is_online:
            # reference Map.cpp:29-57: cell IO drains in the background so
            # registration never waits for a load or an unload
            self._thread_running = True
            self._update_thread = threading.Thread(
                target=self._drain_updates, daemon=True)
            self._update_thread.start()

    # ------------------------------------------------------------ lifecycle
    def shutdown(self):
        if self._update_thread is not None:
            self._thread_running = False
            self._update_queue.put(None)
            self._update_thread.join(timeout=5)
            self._update_thread = None

    def _drain_updates(self):
        while self._thread_running:
            item = self._update_queue.get()
            try:
                if item is not None:
                    self._apply_update(item)
            finally:
                self._update_queue.task_done()

    def wait_for_updates(self):
        """Block until the queued cell updates are applied."""
        self._update_queue.join()

    # ------------------------------------------------------------ accessors
    def add_mapper_module(self, module):
        self.modules.append(module)

    def set_sensor_max_range(self, value: float):
        self.sensor_max_range = float(value)

    def get_sensor_max_range(self) -> float:
        return self.sensor_max_range

    def known_count(self) -> int:
        """Valid points in the local cloud (one device read, then cached)."""
        with self._lock:
            if self.local is None:
                return 0
            if self._known_count is None:
                self._known_count = int(self.local.count())
            return self._known_count

    def is_local_point_cloud_empty(self) -> bool:
        return self.known_count() == 0

    def get_local_point_cloud(self) -> Optional[PointBatch]:
        with self._lock:
            return self.local

    def get_new_local_point_cloud(self):
        """Consume-once local map (reference ``Map.cpp:536-550``)."""
        with self._lock:
            if self.new_local_available and self.local is not None:
                self.new_local_available = False
                return self.local
            return None

    def merge_headroom_scans(self) -> int:
        """Free-slot headroom the module chain needs, in scans (see
        ``MapperModule.INSERTS``)."""
        return max(1, sum(getattr(m, "INSERTS", 0) for m in self.modules))

    def growth_bounded_by_decimation(self) -> bool:
        """True when an active OctreeMapperModule reclaims the inserted scan
        points every merge: the map then grows only by its new voxels, and
        the pipelined Mapper sizes its headroom from measured growth."""
        return any(getattr(m, "NAME", "") == "OctreeMapperModule"
                   and float(m.params.get("maxSizeByNode", 0)) > 0
                   for m in self.modules)

    def set_local(self, local: PointBatch, count: Optional[int] = None,
                  draws: Optional[DrawSource] = None) -> None:
        """Install a new local cloud and hand it to the ICP engine."""
        with self._lock:
            self.local = local
            self._known_count = count
            self.icp.set_map(local, draws)
            self.new_local_available = True

    def grow_local(self, capacity: int) -> None:
        """Pad the local cloud to ``capacity`` (same points, same count);
        the ICP engine pads its reference alike."""
        self.local = self.local.pad_to(capacity)
        self.icp.grow_map(self.local)
        self.new_local_available = True

    # --------------------------------------------------------- merge pipeline
    def update_local_point_cloud(self, scan: PointBatch, pose,
                                 post_filters,
                                 draws: Optional[DrawSource] = None,
                                 scan_valid_hint: Optional[int] = None) -> None:
        """Reference ``Map.cpp:502-534``.

        ``scan_valid_hint`` is an upper bound on the scan's valid-point
        count (the loader knows it before padding); it sizes the map
        buffer's free-slot headroom tighter than ``scan.capacity`` would.
        """
        pose_t = torch.as_tensor(np.asarray(pose), dtype=torch.float32)
        hint = int(scan_valid_hint) if scan_valid_hint else scan.capacity
        headroom = self.merge_headroom_scans() * hint
        with self._lock:
            if self.is_local_point_cloud_empty():
                cap = bucket_capacity(hint + headroom)
                base = PointBatch.empty(cap, scan.dim, device=scan.device)
                local = merge_scan(self.modules, scan, base, pose_t,
                                   post_filters, draws, create=True)
            else:
                cap = bucket_capacity(self.known_count() + headroom)
                local = self.local.pad_to(cap) \
                    if cap > self.local.capacity else self.local
                local = merge_scan(self.modules, scan, local, pose_t,
                                   post_filters, draws)
            self.set_local(local, int(local.count()), draws)

    # --------------------------------------------------------- rolling window
    def update_pose(self, pose: np.ndarray, defer: bool = False):
        """Reference ``Map.cpp:246-460`` -- window shift with 2-cell
        hysteresis; entering slabs load, leaving slabs unload.

        With ``defer=True`` the window advances but its load/unload events
        are returned instead of applied (``_apply_update`` applies one);
        otherwise the result is ``None``."""
        deferred: Optional[List] = [] if defer else None
        pose = np.asarray(pose)
        d = self.dim
        p = pose[:d, d]
        rng = self.sensor_max_range
        inf = [_to_inferior_grid(float(p[a]), rng) for a in range(d)]
        sup = [_to_superior_grid(float(p[a]), rng) for a in range(d)]
        if not self.is_3d:
            inf += [0]
            sup += [0]

        if self.first_pose_update:
            self._window = [inf[0], sup[0], inf[1], sup[1], inf[2], sup[2]]
            self.cell_manager.clear_all_cells()
            with self._lock:
                self.loaded_cell_ids = set()
            # partition everything into cells, then restore the window
            self._unload_cells(_MIN_GRID, _MAX_GRID, _MIN_GRID, _MAX_GRID,
                               _MIN_GRID, _MAX_GRID)
            B = BUFFER_SIZE
            self._load_cells(inf[0] - B, sup[0] + B, inf[1] - B, sup[1] + B,
                             inf[2] - B, sup[2] + B)
            self.first_pose_update = False
            return deferred

        w = self._window
        B = BUFFER_SIZE
        # per-axis, per-edge shifts; axes: 0=row(x), 1=column(y), 2=aisle(z)
        n_axes = 3 if self.is_3d else 2
        for axis in range(n_axes):
            lo_i, hi_i = 2 * axis, 2 * axis + 1
            new_lo, new_hi = inf[axis], sup[axis]
            # inferior edge
            if abs(new_lo - w[lo_i]) >= 2:
                if new_lo < w[lo_i]:  # window grew: load entering slab
                    nb = w[lo_i] - new_lo
                    self._schedule_slab(axis, new_lo - B, new_lo - B + nb - 1,
                                        w, load=True, deferred=deferred)
                else:  # window shrank: unload leaving slab
                    nb = new_lo - w[lo_i]
                    self._schedule_slab(axis, w[lo_i] - B, w[lo_i] - B + nb - 1,
                                        w, load=False, deferred=deferred)
                w[lo_i] = new_lo
            # superior edge
            if abs(new_hi - w[hi_i]) >= 2:
                if new_hi < w[hi_i]:
                    nb = w[hi_i] - new_hi
                    self._schedule_slab(axis, w[hi_i] + B - nb + 1,
                                        w[hi_i] + B, w, load=False,
                                        deferred=deferred)
                else:
                    nb = new_hi - w[hi_i]
                    self._schedule_slab(axis, new_hi + B - nb + 1,
                                        new_hi + B, w, load=True,
                                        deferred=deferred)
                w[hi_i] = new_hi
        return deferred

    def _schedule_slab(self, axis: int, start: int, end: int, w, load: bool,
                       deferred: Optional[List] = None):
        B = BUFFER_SIZE
        bounds = [w[0] - B, w[1] + B, w[2] - B, w[3] + B, w[4] - B, w[5] + B]
        bounds[2 * axis] = start
        bounds[2 * axis + 1] = end
        if not self.is_3d:
            bounds[4], bounds[5] = 0, 0
        update = (load, tuple(bounds))
        if deferred is not None:
            deferred.append(update)
        elif self.is_online:
            self._update_queue.put(update)
        else:
            self._apply_update(update)

    def _apply_update(self, update):
        load, bounds = update
        if load:
            self._load_cells(*bounds)
        else:
            self._unload_cells(*bounds)

    # ------------------------------------------------------------- cell IO
    def _cell_id(self, i: int, j: int, k: int) -> str:
        return f"{i}_{j}_{k}"

    def _iter_cells(self, sr, er, sc, ec, sa, ea):
        if not self.is_3d:
            sa, ea = 0, 0
        for i in range(sr, er + 1):
            for j in range(sc, ec + 1):
                for k in range(sa, ea + 1):
                    yield i, j, k

    def _load_cells(self, sr, er, sc, ec, sa, ea):
        """Reference ``Map.cpp:71-128``."""
        chunks: List[Dict[str, np.ndarray]] = []
        ids = []
        # clamp enumeration to cells that actually exist (for the full-grid
        # first-update range enumerating the request is infeasible --
        # intersect with the saved-cell set).  ``loaded_cell_ids`` records
        # only cells whose saved content is now merged into the local cloud.
        saved = set(self.cell_manager.get_all_cell_ids())
        span = (er - sr + 1) * (ec - sc + 1) * ((ea - sa + 1) if self.is_3d else 1)
        if span > len(saved) * 4 + 64:
            candidates = []
            for cid in saved:
                i, j, k = (int(v) for v in cid.split("_"))
                if sr <= i <= er and sc <= j <= ec and (
                        not self.is_3d or sa <= k <= ea):
                    candidates.append((i, j, k))
        else:
            candidates = list(self._iter_cells(sr, er, sc, ec, sa, ea))
        for (i, j, k) in candidates:
            cid = self._cell_id(i, j, k)
            if cid in saved:
                cell = self.cell_manager.retrieve_cell(cid)
                # remove-on-load: the retrieved content becomes device
                # resident, so the saved copy leaves the store (a point is
                # device-resident OR in exactly one saved cell); without it,
                # re-unloading a revisited cell would merge onto the stale
                # saved copy and double the map on every leave-return cycle.
                self.cell_manager.remove_cell(cid)
                if cell is not None and cell["positions"].shape[0] > 0:
                    chunks.append(cell)
                ids.append(cid)
        with self._lock:
            if chunks:
                data = _stack_cells(chunks)
                pos = data.pop("positions")
                incoming = PointBatch.from_numpy(pos[:, :self.dim], data,
                                                 device=self.device)
                if self.is_local_point_cloud_empty():
                    self.set_local(incoming, pos.shape[0])
                else:
                    n_total = self.known_count() + pos.shape[0]
                    self.set_local(
                        concatenate(self.local, incoming,
                                    capacity=bucket_capacity(n_total)),
                        n_total)
            self.loaded_cell_ids.update(ids)

    def _unload_cells(self, sr, er, sc, ec, sa, ea):
        """Reference ``Map.cpp:140-230`` -- partition local cloud by world
        bounds of the cell range, evict the inside portion binned per cell."""
        if not self.is_3d:
            sa, ea = 0, 0
        with self._lock:
            if self.local is None:
                return
            data = self.local.to_numpy()
        pos = data["positions"]
        if pos.shape[0] == 0:
            return
        lo = np.array([sr, sc, sa][: self.dim], np.float64) * CELL_SIZE
        hi = (np.array([er, ec, ea][: self.dim], np.float64) + 1.0) * CELL_SIZE
        inside = np.all((pos >= lo) & (pos < hi), axis=1)

        keep = {k: v[~inside] for k, v in data.items()}
        evict = {k: v[inside] for k, v in data.items()}

        desc_keep = {k: v for k, v in keep.items() if k != "positions"}
        self.set_local(PointBatch.from_numpy(keep["positions"], desc_keep,
                                             device=self.device),
                       keep["positions"].shape[0])
        if (er - sr) >= 10**6:  # full-grid unload: everything leaves
            self.loaded_cell_ids = set()
        else:
            for (i, j, k) in self._iter_cells(sr, er, sc, ec, sa, ea):
                self.loaded_cell_ids.discard(self._cell_id(i, j, k))

        bin_points_to_cells(evict, self.cell_manager, self.dim)

    # -------------------------------------------------------- global import/export
    def get_global_point_cloud(self) -> Dict[str, np.ndarray]:
        """Local cloud + all saved cells not currently loaded
        (reference ``Map.cpp:552-573``). Host-side compact arrays."""
        with self._lock:
            parts = []
            if self.local is not None:
                parts.append(self.local.to_numpy())
            loaded = set(self.loaded_cell_ids)
        for cid in self.cell_manager.get_all_cell_ids():
            if cid not in loaded:
                cell = self.cell_manager.retrieve_cell(cid)
                if cell is not None and cell["positions"].shape[0] > 0:
                    parts.append(cell)
        if not parts:
            return {"positions": np.zeros((0, self.dim), np.float32)}
        return _stack_cells(parts)

    def set_global_point_cloud(self, cloud) -> None:
        """Reference ``Map.cpp:575-588``: replace local cloud, re-arm the
        first-pose partition."""
        if isinstance(cloud, PointBatch):
            batch = cloud.to(self.device)
        else:
            desc = {k: v for k, v in cloud.items() if k != "positions"}
            batch = PointBatch.from_numpy(
                np.asarray(cloud["positions"])[:, : self.dim], desc,
                device=self.device)
        was_new = self.new_local_available
        self.set_local(batch, None)
        self.new_local_available = was_new
        self.first_pose_update = True
