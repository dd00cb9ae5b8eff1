"""Mapper facade: config load, input filtering, ICP, update policy, bookkeeping.

Parity with reference ``Mapper.{h,cpp}``:

  - ctor ``(config, is_3d, is_online, is_mapping, ...)``
  - strict YAML schema ``{icp, input, post, mapper}`` with duplicate/unknown
    key rejection and range checks
  - ``apply_input_filters`` = always-on radius filter (DistanceLimit at
    sensorMaxRange, built after config load) + input chain
  - ``process_input`` hot path: transform scan to map frame with the pose
    prior, ICP correction, conditional map update (distance / overlap /
    delay policy), pose + trajectory bookkeeping
  - defaults when config sections are missing: distance condition 1.0 m,
    PointDistanceMapperModule(minDistNewPoint=0.15)

The first scan (an empty map) takes the stepwise path, and so does every
scan of a config with a BoundTransformationChecker (its throw happens on the
host).  Every other scan runs the pipelined loop of the JAX package: one
:class:`~norlab_icp_mapper_tpu_torch.fused.FusedScanStep` per scan
(``register`` then ``merge``, enqueued back to back), whose small outputs --
pose, iterations, map count -- come back as *mirrors*: non-blocking copies
into pinned host memory with a CUDA event behind them.  A scan is harvested
once its event has passed (``event.query()``), so the host never waits for
the card in the loop, except for the oldest scan when ``PIPELINE_DEPTH``
scans are in flight, under capacity pressure, before a shrink, at a scan
that applies deferred rolling-window events and at one that re-merges an
overflowing scan, and at the merge decision of the ``distance`` and
``overlap`` conditions (``fused.py``); ``waits`` counts each, and the
enabled ``timer`` (``fused.PhaseTimer``) times each as ``wait.<cause>``
beside ``host.process_input``, ``host.input_filters`` and the device
phases.  The map's capacity
is sized from a provisional bound (last harvested count + one headroom per
scan in flight), with adaptive headroom for decimating configs, a shrink
when the buffer is a bucket oversize, and a re-merge of a scan that filled
the buffer.

Online (``is_online=True``): the pose mirror is filed after ``register``,
so ``get_pose()`` waits for the solve and not for the merge; the stepwise
path merges on a single-worker executor, and the map applies the cell
events of its rolling window on a background thread.

Keyframes (``enable_keyframes``): a sensor-frame scan and its corrected
pose are kept at map updates spaced ``min_distance`` apart, captured at
harvest on the pipelined loop and in ``_update_map`` on the stepwise one;
``refine_trajectory`` runs the pose graph of ``slam/pose_graph.py`` over
them.  Configs with an ICP inspector take the stepwise path.

With ``mesh`` (``parallel.make_mesh()``), the same config drives the
sharded backend (``parallel/sharded_map.py``): the map is split over the
ranks of the mesh and every per-scan pass runs on each rank's block with
``torch.distributed`` collectives between them.
"""
from __future__ import annotations

import collections
import concurrent.futures
from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import yaml

from . import se3
from .draws import DrawSource, resolve_device, upload
from .points import PointBatch, bucket_capacity
from .filters.core import FilterChain, filter_registry
from .fused import FusedScanStep, PhaseTimer
from .icp.engine import ICPEngine
from .map import Map
from .mapper_modules.core import mapper_module_registry
from .trajectory import Trajectory

__all__ = ["Mapper"]

DEFAULT_MAP_UPDATE_CONDITION = "distance"  # reference Mapper.h
DEFAULT_MAP_UPDATE_DISTANCE = 1.0


class _UniqueKeyLoader(yaml.SafeLoader):
    """YAML loader that rejects duplicate keys (reference
    ``validateYamlKeys``; PyYAML silently keeps the last duplicate
    otherwise)."""

    def construct_mapping(self, node, deep=False):
        seen = set()
        for key_node, _ in node.value:
            key = self.construct_object(key_node, deep=deep)
            if key in seen:
                raise yaml.YAMLError(
                    f"Duplicated key: {key} (line {key_node.start_mark.line + 1})")
            seen.add(key)
        return super().construct_mapping(node, deep)


class _Mirror:
    """Host copies of a few small device tensors of one scan: copied
    without blocking into pinned memory, with a CUDA event recorded behind
    the copies on the current stream.  On the CPU the tensors are their own
    mirror and are ready at once."""

    def __init__(self, **tensors: torch.Tensor):
        dev = next(iter(tensors.values())).device
        self.event = None
        if dev.type == "cuda":
            self.host = {}
            for k, t in tensors.items():
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self.host[k] = h
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host = {k: t.clone() for k, t in tensors.items()}

    def ready(self) -> bool:
        return self.event is None or self.event.query()

    def get(self) -> Dict[str, torch.Tensor]:
        """The host copies, once they have landed (waits for them)."""
        if self.event is not None:
            self.event.synchronize()
        return self.host


class Mapper:
    PIPELINE_DEPTH = 4  # scans in flight before the oldest is waited for

    def __init__(self, config: Union[str, Dict[str, Any], None],
                 is_3d: bool = True, is_online: bool = False,
                 is_mapping: bool = True,
                 save_map_cells_on_hard_drive: bool = False,
                 seed: int = 0,
                 device: Union[str, torch.device, None] = "cuda",
                 draw_source: Optional[Callable[[str, int],
                                                torch.Tensor]] = None,
                 mesh=None,
                 sharded_options: Optional[Dict[str, Any]] = None):
        """``device`` is where the clouds live and the kernels run; it
        defaults to the card and raises if there is none (pass
        ``device="cpu"`` to run on the CPU, as the tests do).

        ``seed`` seeds the generator behind every random draw (random
        sampling, octree tie-breaks); ``draw_source(site, n) -> Tensor``
        replaces that generator with the caller's own draws (see
        ``draws.py``).

        With ``mesh`` (a ``DeviceMesh`` from ``parallel.make_mesh``) the map
        is sharded over the mesh's ranks (``parallel.ShardedMapper``);
        ``device`` is this rank's (under NCCL it must be the rank's card)
        and ``sharded_options`` overrides the sharded-only knobs
        (cell_size, halo_capacity, ...)."""
        self.device = resolve_device(device)
        if mesh is not None:
            from .parallel.sharded_map import shard_device
            if not hasattr(mesh, "get_group"):
                raise TypeError(f"mesh must be a DeviceMesh "
                                f"(parallel.make_mesh()), not {mesh!r}")
            self.device = shard_device(mesh, self.device)
        self.seed = int(seed)
        self.is_3d = is_3d
        self.dim = 3 if is_3d else 2
        self.is_online = is_online
        self.is_mapping = is_mapping
        self.draws = DrawSource(seed, self.device, draw_source)
        self.timer = PhaseTimer()
        self.icp = ICPEngine(config=None, dim=self.dim)
        self.map = Map(is_3d, is_online, save_map_cells_on_hard_drive,
                       self.icp, device=self.device)
        self.trajectory = Trajectory(3 if is_3d else 2)
        self._pose: Optional[np.ndarray] = None
        # the solve mirror of the latest pipelined scan (get_pose waits for
        # it), None once drained
        self._live: Optional[_Mirror] = None

        self.map_update_condition = DEFAULT_MAP_UPDATE_CONDITION
        self.map_update_distance = DEFAULT_MAP_UPDATE_DISTANCE
        self.map_update_overlap = 0.9
        self.map_update_delay = 1.0
        self.last_time_map_was_updated = -np.inf  # ns
        self.last_pose_where_map_was_updated = np.eye(self.dim + 1, dtype=np.float32)
        self.overlap = 0.0
        self.last_iterations = 0  # ICP iterations of the latest scan

        self.input_filters = FilterChain([])
        self.post_filters = FilterChain([])
        self.load_config(config)

        # the radius filter is built AFTER config load so it picks up the
        # configured sensorMaxRange (reference Mapper.cpp:25-31)
        self.radius_filter = FilterChain([filter_registry.create(
            "DistanceLimitDataPointsFilter",
            {"dim": -1, "dist": self.map.get_sensor_max_range(),
             "removeInside": 0})])
        self._input_all = FilterChain(
            self.radius_filter.filters + self.input_filters.filters)

        self._map_update_future: Optional[concurrent.futures.Future] = None
        self._executor = (
            concurrent.futures.ThreadPoolExecutor(max_workers=1)
            if is_online else None)

        # the pipelined loop (see the module docstring)
        self._fused = FusedScanStep(self)
        self._fused_state = None  # (bufs, meta) while scans are in flight
        self._fused_pending: "collections.deque" = collections.deque()
        self._pending_headroom_sum = 0
        self._fused_base_count: Optional[int] = None  # last harvested count
        # per-merge count deltas (harvested) size the adaptive headroom of
        # decimating configs
        self._delta_hist: "collections.deque" = collections.deque(maxlen=16)
        self._overflow_remerge = None  # (scan, pose): see _remerge_overflow
        # latest harvested correction (corrected @ est^-1): applied to the
        # current prior it drives the rolling window at dispatch, no lag
        self._win_corr: Optional[np.ndarray] = None
        self._pending_window: list = []
        self._epoch_ns: Optional[int] = None
        # the host's waits for the card, by cause
        self.waits = {"pipeline_depth": 0, "capacity": 0, "shrink": 0,
                      "window_events": 0, "remerge": 0, "merge_decision": 0}
        # keyframes for pose-graph refinement (off unless enable_keyframes()
        # is called): [(positions, mask, pose)], the clouds on the device
        self._kf_cfg: Optional[dict] = None
        self._keyframes: list = []

        # the sharded backend: the same parsed config, the map over the mesh
        self._sharded = None
        if mesh is not None:
            from .parallel.sharded_map import ShardedMapper
            self._sharded = ShardedMapper.from_mapper(self, mesh,
                                                      sharded_options)
            self.trajectory = self._sharded.trajectory

    # ----------------------------------------------------------------- config
    def load_config(self, config: Union[str, Dict[str, Any], None]):
        """Reference ``loadYamlConfig`` (``Mapper.cpp:59-185``)."""
        if config is None:
            node: Dict[str, Any] = {}
        elif isinstance(config, str):
            try:
                with open(config) as f:
                    node = yaml.load(f, Loader=_UniqueKeyLoader) or {}
            except FileNotFoundError:
                raise RuntimeError(
                    f"The input config file {config} does not exist")
        else:
            node = dict(config)

        valid = {"icp", "input", "post", "mapper"}
        for k in node:
            if k not in valid:
                raise ValueError(f"Invalid key: {k}")

        if "icp" in node and node["icp"] is not None:
            self.icp.load_config(node["icp"])
        else:
            print("icp config not found, using default")
            self.icp.set_default()

        if "input" in node and node["input"] is not None:
            self.input_filters = FilterChain.from_yaml(node["input"])
        else:
            print("Input config not found, using empty configuration.")
            self.input_filters = FilterChain([])

        if "post" in node and node["post"] is not None:
            self.post_filters = FilterChain.from_yaml(node["post"])
        else:
            print("Post config not found, using empty configuration.")
            self.post_filters = FilterChain([])

        if "mapper" in node and node["mapper"] is not None:
            mnode = node["mapper"]
            for k in mnode:
                if k not in ("updateCondition", "sensorMaxRange", "mapperModule"):
                    raise ValueError(f"Invalid key: {k}")
            if "updateCondition" in mnode:
                uc = mnode["updateCondition"]
                for k in uc:
                    if k not in ("type", "value"):
                        raise ValueError(f"Invalid key: {k}")
                if "type" not in uc:
                    raise ValueError("Missing key: type")
                if "value" not in uc:
                    raise ValueError("Missing key: value")
                cond = str(uc["type"])
                value = float(uc["value"])
                if cond == "distance":
                    if value < 0:
                        raise ValueError(f"Invalid map update distance: {value}")
                    self.map_update_distance = value
                elif cond == "overlap":
                    if value < 0 or value > 1:
                        raise ValueError(f"Invalid map update overlap: {value}")
                    self.map_update_overlap = value
                elif cond == "delay":
                    if value < 0:
                        raise ValueError(f"Invalid map update delay: {value}")
                    self.map_update_delay = value
                else:
                    raise ValueError(f"Invalid map update condition: {cond}")
                self.map_update_condition = cond
            else:
                print("Mapper update condition not found, using default configuration.")
                self._set_default_map_update_config()
            if "sensorMaxRange" in mnode:
                smr = float(mnode["sensorMaxRange"])
                if smr < 0:
                    raise ValueError(f"Invalid sensor max range: {smr}")
                self.map.set_sensor_max_range(smr)
            if "mapperModule" in mnode:
                for entry in mnode["mapperModule"]:
                    self.map.add_mapper_module(
                        mapper_module_registry.create_from_yaml_entry(entry))
            else:
                print("mapper module not found, using default")
                self._set_default_mapper_module()
        else:
            print("mapper config not found, using default")
            self._set_default_map_update_config()
            self._set_default_mapper_module()

    def _set_default_map_update_config(self):
        self.map_update_condition = DEFAULT_MAP_UPDATE_CONDITION
        self.map_update_distance = DEFAULT_MAP_UPDATE_DISTANCE

    def _set_default_mapper_module(self):
        # reference Mapper.cpp:330-336
        self.map.add_mapper_module(mapper_module_registry.create(
            "PointDistanceMapperModule", {"minDistNewPoint": 0.15}))

    # -------------------------------------------------------------- hot path
    def apply_input_filters(self, scan: PointBatch) -> PointBatch:
        """Reference ``Mapper.cpp:187-191`` (scan in sensor frame): the
        radius filter, then the input chain."""
        with self.timer.host("input_filters"):
            return self._input_all.apply(scan.to(self.device), self.draws)

    def process_input(self, filtered_scan_in_sensor_frame: PointBatch,
                      estimated_pose: np.ndarray, timestamp_ns: int,
                      scan_valid_hint: Optional[int] = None) -> None:
        """Reference ``Mapper.cpp:194-238``.

        ``scan_valid_hint``: optional upper bound on the scan's valid point
        count (the loader knows it pre-padding); tightens map-buffer
        headroom sizing.  The bootstrap scan (empty map) and configs with a
        bound checker take the stepwise path; every other scan enters the
        pipelined loop and returns without waiting for the card.
        """
        with self.timer.host("process_input"):
            self._process_input(filtered_scan_in_sensor_frame,
                                estimated_pose, timestamp_ns, scan_valid_hint)

    def _process_input(self, filtered_scan_in_sensor_frame: PointBatch,
                       estimated_pose: np.ndarray, timestamp_ns: int,
                       scan_valid_hint: Optional[int]) -> None:
        estimated_pose = np.asarray(estimated_pose, dtype=np.float32)
        scan = filtered_scan_in_sensor_frame.to(self.device)
        if self._sharded is not None:
            self._process_input_sharded(scan, estimated_pose, timestamp_ns,
                                        scan_valid_hint)
            return
        if self._epoch_ns is None:
            self._epoch_ns = int(timestamp_ns)
        # lpm's bound checker THROWS on violation; only the stepwise path
        # can raise host-side (the engine's __call__ reproduces it); an
        # inspector records every iteration, which only the stepwise path's
        # engine call does
        if (self.icp.bound_checker is None and self.icp.inspector is None
                and (self._fused_state is not None
                     or (not self.map.first_pose_update
                         and not self.map.is_local_point_cloud_empty()))):
            self._process_input_fused(scan, estimated_pose, timestamp_ns,
                                      scan_valid_hint)
            return

        self._drain_fused()
        pose_t = torch.from_numpy(estimated_pose)
        scan_m = se3.apply(pose_t, scan)

        if self.map.is_local_point_cloud_empty():
            corrected = estimated_pose
            self.map.update_pose(corrected)
            self._update_map(scan_m, corrected, timestamp_ns, scan_valid_hint)
        else:
            result = self.icp(scan_m, self.draws)
            correction = result.correction.numpy()
            self.overlap = float(result.overlap)
            self.last_iterations = result.iterations
            corrected = correction @ estimated_pose
            self.map.update_pose(corrected)
            if self._should_update_map(timestamp_ns, corrected, self.overlap):
                corrected_scan = se3.apply(result.correction, scan_m)
                self._update_map(corrected_scan, corrected, timestamp_ns,
                                 scan_valid_hint)

        if (self._map_update_future is not None
                and self._map_update_future.done()):
            self._map_update_future.result()
            self._map_update_future = None

        self.pose = np.asarray(corrected, dtype=np.float32)
        self.trajectory.add_pose(self._pose, timestamp_ns)

    def _process_input_sharded(self, scan: PointBatch,
                               estimated_pose: np.ndarray, timestamp_ns: int,
                               scan_valid_hint: Optional[int]) -> None:
        read_mask = None
        if len(self.icp.reading_filters):
            # readingDataPointsFilters: applied once per registration to the
            # reading only, the merged scan stays unfiltered.  The
            # single-device engine gets the reading in the MAP frame, so the
            # mask is computed on the transformed scan (frame-sensitive
            # filters agree across backends); position-editing reading
            # filters are refused at construction
            scan_m = se3.apply(upload(estimated_pose, self.device), scan)
            read_mask = self.icp.reading_filters.apply(scan_m,
                                                       self.draws).mask
        sh = self._sharded
        sh.process_input(scan, estimated_pose, timestamp_ns=int(timestamp_ns),
                         is_mapping=self.is_mapping, read_mask=read_mask,
                         scan_valid_hint=scan_valid_hint)
        if sh._overlap is not None:
            self.overlap = sh._overlap
            self.last_iterations = sh.last_iterations

    # ---------------------------------------------------- the pipelined loop
    def _process_input_fused(self, scan: PointBatch,
                             estimated_pose: np.ndarray, timestamp_ns: int,
                             scan_valid_hint: Optional[int] = None) -> None:
        """One ``register`` + ``merge`` per scan, enqueued on the card; the
        host work is bookkeeping and never waits for the card, except where
        ``waits`` counts it."""
        # apply the window events deferred from the previous scan (a sync)
        if self._pending_window:
            with self._waiting("window_events"):
                self._drain_fused()
        if self._overflow_remerge is not None:
            scan_o, pose_o = self._overflow_remerge
            self._overflow_remerge = None
            with self._waiting("remerge"):
                self._remerge_overflow(scan_o, pose_o)
        hint = int(scan_valid_hint) if scan_valid_hint else scan.capacity
        bufs, meta = self._ensure_fused_state()
        headroom = max(1, self.map.merge_headroom_scans()) * hint
        if (self.map.growth_bounded_by_decimation()
                and len(self._delta_hist) >= 4):
            # an octree config reclaims (almost) the whole scan at every
            # merge: the map grows by its new voxels only.  The headroom
            # follows the measured growth (x4 + a floor); a burst scan that
            # beats it fills the buffer, the harvested count shows it, and
            # _remerge_overflow replays that scan after growing.
            headroom = min(headroom,
                           max(4 * max(self._delta_hist) + 4096, 8192))
        if self._fused_base_count is None:
            self._fused_base_count = (
                self.map._known_count if self.map._known_count is not None
                else int(bufs["map"].count()))

        def ub():
            # provisional bound: last harvested count + one headroom per
            # scan in flight (each could have merged)
            return self._fused_base_count + self._pending_headroom_sum

        # shrink when the buffer is at least one capacity bucket (12.5 %)
        # oversize for the adaptive target
        target = bucket_capacity(self._fused_base_count + 2 * headroom)
        if target * 8 <= bufs["map"].capacity * 7:
            if self._fused_pending:
                with self._waiting("shrink"):
                    self._harvest_all()
            target = bucket_capacity(self._fused_base_count + 2 * headroom)
            if target * 8 <= bufs["map"].capacity * 7 \
                    and target >= (self.map._known_count or 0):
                bufs = self._shrink_bufs(bufs, target)
                self._fused_state = (bufs, meta)

        if ub() + headroom > bufs["map"].capacity:
            # a scan that did not merge added nothing: release its headroom
            # (the decision is a host boolean here, known at dispatch)
            for e in self._fused_pending:
                if not e["resolved"]:
                    if not e["merged"]:
                        self._pending_headroom_sum -= e["headroom"]
                        e["headroom"] = 0
                    e["resolved"] = True
        while self._fused_pending and \
                ub() + headroom > bufs["map"].capacity:
            # the bound is provisional: harvest the real counts oldest
            # first before growing, so that phantom slack never grows the
            # buffers (every capacity-proportional pass pays for it)
            entry = self._fused_pending.popleft()
            if entry["count"].ready():
                self._harvest_entry(entry)
            else:
                with self._waiting("capacity"):
                    self._harvest_entry(entry)
        if ub() + headroom > bufs["map"].capacity:
            # two scans of slack keep the loop free-running; the reference
            # is padded alike and the matcher's pack rebuilt
            self.map.grow_local(bucket_capacity(ub() + 2 * headroom))
            bufs = dict(bufs, map=self.map.local, ref_pack=self.icp._ref_pack)
            if "ref" in bufs:
                bufs["ref"] = self.icp._ref

        # f32 seconds relative to the mapper's epoch (the delay gate's
        # operand); the merge timestamps are kept at harvest in exact ns
        stamp_s = np.float32((int(timestamp_ns) - self._epoch_ns) * 1e-9)
        try:
            new_meta, aux = self._fused.register(
                bufs, meta, scan, estimated_pose, stamp_s, self.is_mapping)
            # filed before the merge in stream order: a reader of the pose
            # waits for the solve only
            solve = _Mirror(pose=new_meta["pose"], iterations=aux["iterations"],
                            **({} if aux["nn_grid"] is None
                               else {"nn_grid": aux["nn_grid"]}))
            new_bufs, count = self._fused.merge(bufs, aux)
            count = _Mirror(count=count)
        except Exception as e:
            # drop every handle of the state the failed step was writing,
            # so that later accessors fail loudly instead of reading a
            # half-merged map
            self._fused_state = None
            self._fused_pending.clear()
            self._pending_headroom_sum = 0
            self._live = None
            self.map.local = None
            self.map._known_count = 0
            self.icp._ref = None
            self.icp._ref_pack = None
            raise RuntimeError(
                "fused scan step failed mid-dispatch; the map state it was "
                "updating is unrecoverable -- rebuild the Mapper or "
                "set_map() before continuing") from e
        self._fused_state = (new_bufs, new_meta)

        # live handles, nothing read
        self.map.local = new_bufs["map"]
        self.map._known_count = None
        self.icp._ref = new_bufs.get("ref", new_bufs["map"])
        self.icp._ref_pack = new_bufs["ref_pack"]
        self.overlap = aux["overlap"]
        self.last_iterations = aux["iterations"]
        self._live = solve
        self.trajectory.add_pose(new_meta["pose"], timestamp_ns)

        self._fused_pending.append({
            "solve": solve, "count": count, "merged": aux["merged"],
            "stamp_ns": int(timestamp_ns), "headroom": headroom,
            "resolved": False, "cap": new_bufs["map"].capacity,
            "est": estimated_pose, "scan": scan, "replay": aux["replay"]})
        self._pending_headroom_sum += headroom

        # rolling window driven now from the correction-adjusted prior (no
        # lag); its events apply at the next scan's start
        win_pose = (estimated_pose if self._win_corr is None
                    else self._win_corr @ estimated_pose)
        upd = self.map.update_pose(np.asarray(win_pose, np.float32),
                                   defer=True)
        if upd:
            self._pending_window.extend(upd)

        # fold in every scan whose mirrors have landed; wait only for the
        # oldest of a full pipeline
        while self._fused_pending and self._fused_pending[0]["count"].ready():
            self._harvest_entry(self._fused_pending.popleft())
        while len(self._fused_pending) > self.PIPELINE_DEPTH:
            with self._waiting("pipeline_depth"):
                self._harvest_entry(self._fused_pending.popleft())

    def _waiting(self, cause: str):
        """Count one blocking read of the card under ``cause`` in ``waits``
        and return the span that times it (``PhaseTimer.wait``); every
        counted wait is taken through here, around the call that blocks."""
        self.waits[cause] += 1
        return self.timer.wait(cause)

    def _harvest_entry(self, entry) -> None:
        """Fold one scan's mirrors (pose, iterations, the grid matcher's
        counts, map count) into the host bookkeeping.  Merge stamps and
        poses are kept here in exact integer ns and full precision; the f32
        ``last_t`` of the step is only the delay gate's operand."""
        solve = entry["solve"].get()
        count_prev = int(entry["count"].get()["count"])
        pose_prev = solve["pose"].numpy().copy()
        iters = int(solve["iterations"])
        self.timer.count("icp_iterations", iters)
        if "nn_grid" in solve:
            queries, fallbacks = solve["nn_grid"].tolist()
            self.timer.count("nn_grid_queries", queries)
            self.timer.count("nn_grid_fallbacks", fallbacks)
        if entry["replay"] is not None:
            # a solve graph counts its kernel launches once they are known
            entry["replay"].count(iters)
        prev_base = self._fused_base_count
        self._fused_base_count = count_prev
        self._pending_headroom_sum -= entry["headroom"]
        self.map._known_count = count_prev  # a few scans stale
        if entry["merged"]:
            if prev_base is not None:
                self._delta_hist.append(max(0, count_prev - prev_base))
            if (self.map.growth_bounded_by_decimation()
                    and entry["cap"] - count_prev < 1024):
                # the merge filled the buffer: points may have been
                # dropped; replay the scan after growing (a backstop of the
                # adaptive headroom only; see _remerge_overflow)
                self._overflow_remerge = (entry["scan"], pose_prev)
            self.map.new_local_available = True
            self.last_time_map_was_updated = entry["stamp_ns"]
            self.last_pose_where_map_was_updated = pose_prev
            if self._kf_cfg is not None:
                self._maybe_keyframe(entry["scan"], pose_prev)
        self._win_corr = (
            pose_prev.astype(np.float64)
            @ np.linalg.inv(entry["est"].astype(np.float64))
        ).astype(np.float32)

    def _harvest_all(self) -> None:
        """Harvest every scan in flight, waiting for their mirrors."""
        while self._fused_pending:
            self._harvest_entry(self._fused_pending.popleft())

    def _shrink_bufs(self, bufs, target: int):
        """Compact every map-sized buffer and cut it to ``target`` (valid
        points first, order kept); rebuilds the matcher's pack.  Fires once
        the adaptive headroom shows the buffer a bucket oversize."""
        def cut(b):
            b = b.compact()
            return PointBatch(b.positions[:target], b.mask[:target],
                              {k: v[:target]
                               for k, v in b.descriptors.items()})
        out = {k: cut(v) for k, v in bufs.items() if k != "ref_pack"}
        out["ref_pack"] = self.icp.build_ref_pack(out.get("ref", out["map"]))
        self.map.local = out["map"]
        self.icp._ref = out.get("ref", out["map"])
        self.icp._ref_pack = out["ref_pack"]
        return out

    def _remerge_overflow(self, scan: PointBatch, pose_np) -> None:
        """Backstop for a merge that filled the map buffer: with adaptive
        headroom a burst scan (all new territory) can exceed the margin and
        the union writeback drops what did not fit.  The union decimation
        is idempotent for the points already inserted, so merging the same
        scan again through the stepwise path, after growing, inserts
        exactly the dropped points.  DynamicPoints is left out: its update
        already ran and must not count twice."""
        self._drain_fused()
        mods = self.map.modules
        self.map.modules = [m for m in mods
                            if getattr(m, "NAME", "")
                            != "DynamicPointsMapperModule"]
        try:
            pose_np = np.asarray(pose_np, np.float32)
            scan_m = se3.apply(torch.from_numpy(pose_np), scan)
            self.map.update_local_point_cloud(scan_m, pose_np,
                                              self.post_filters, self.draws)
        finally:
            self.map.modules = mods

    def _ensure_fused_state(self):
        if self._fused_state is None:
            # rebase the f32 epoch so in-step relative seconds stay
            # small no matter how long the mapper has been alive
            if np.isfinite(self.last_time_map_was_updated):
                self._epoch_ns = int(self.last_time_map_was_updated)
            last_t = self.last_time_map_was_updated
            last_t_s = ((last_t - self._epoch_ns) * 1e-9
                        if np.isfinite(last_t) else -np.inf)
            pose = (self._pose if self._pose is not None
                    else np.eye(self.dim + 1, dtype=np.float32))
            self._fused_state = self._fused.init_state(
                self.map.get_local_point_cloud(), self.icp._ref, pose,
                self.last_pose_where_map_was_updated, last_t_s)
            self._fused_base_count = self.map._known_count
        return self._fused_state

    def drain(self) -> None:
        """Flush the pipelined loop: wait for every scan in flight and
        bring the host bookkeeping (pose, map count, rolling window) up to
        date.  Call before reading final results."""
        if self._sharded is not None:
            self._sharded.drain()
            self.overlap = float(self.overlap)
            self.last_iterations = int(self.last_iterations or 0)
            return
        self._drain_fused()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _drain_fused(self) -> None:
        """Sync point: harvest the mirrors in flight, apply the deferred
        window events, hand the state back to the Map / ICP bookkeeping."""
        self._harvest_all()
        if self._fused_state is not None:
            self._pose = self._live.get()["pose"].numpy().copy()
            self._live = None
            self.overlap = float(self.overlap)
            self.last_iterations = int(self.last_iterations)
            self._fused_state = None
        for u in self._pending_window:
            self.map._apply_update(u)
        self._pending_window = []

    def _should_update_map(self, now_ns: int, current_pose: np.ndarray,
                           overlap: float) -> bool:
        """Reference ``Mapper.cpp:240-272``."""
        if not self.is_mapping:
            return False
        if self.is_online and self._map_update_future is not None \
                and not self._map_update_future.done():
            return False
        if self.map_update_condition == "overlap":
            return overlap < self.map_update_overlap
        if self.map_update_condition == "delay":
            return (now_ns - self.last_time_map_was_updated) \
                > self.map_update_delay * 1e9
        d = self.dim
        last = self.last_pose_where_map_was_updated[:d, d]
        cur = current_pose[:d, d]
        return float(np.linalg.norm(cur - last)) > self.map_update_distance

    def _update_map(self, scan: PointBatch, pose: np.ndarray,
                    timestamp_ns: int,
                    scan_valid_hint: Optional[int] = None) -> None:
        """Reference ``Mapper.cpp:274-288``; online, the merge runs on the
        single-worker executor (the reference's ``std::async``)."""
        self.last_time_map_was_updated = timestamp_ns
        self.last_pose_where_map_was_updated = np.asarray(pose)
        if self._kf_cfg is not None:
            # this path merges in the MAP frame; keyframes are stored in the
            # sensor frame, like the pipelined loop's
            inv = np.linalg.inv(np.asarray(pose, np.float64)).astype(
                np.float32)
            self._maybe_keyframe(se3.apply(torch.from_numpy(inv), scan),
                                 np.asarray(pose))
        if self.is_online and not self.map.is_local_point_cloud_empty():
            self._map_update_future = self._executor.submit(
                self.map.update_local_point_cloud, scan, pose,
                self.post_filters, self.draws, scan_valid_hint)
        else:
            self.map.update_local_point_cloud(scan, pose, self.post_filters,
                                              self.draws, scan_valid_hint)

    # ------------------------------------------------------------ keyframes
    def enable_keyframes(self, min_distance: float = 1.0,
                         max_keyframes: int = 256):
        """Record a keyframe (sensor-frame scan + corrected pose) at map
        updates spaced at least ``min_distance`` apart: the input of
        ``refine_trajectory``.  At ``max_keyframes`` the store is thinned
        (``slam.pose_graph.keyframe_insert``).  With a mesh the sharded
        mapper captures them and its store is shared here."""
        if self._sharded is not None:
            self._sharded.enable_keyframes(min_distance, max_keyframes)
            self._keyframes = self._sharded._keyframes  # the same list
            self._kf_cfg = self._sharded._kf_cfg
            return
        self._kf_cfg = {"min_distance": float(min_distance),
                        "max_keyframes": int(max_keyframes)}
        self._keyframes = []

    def _maybe_keyframe(self, scan: PointBatch, pose: np.ndarray):
        from .slam.pose_graph import keyframe_insert
        keyframe_insert(self._keyframes, self._kf_cfg, scan.positions,
                        scan.mask, np.asarray(pose, np.float32), self.dim)

    @property
    def keyframe_thinning_events(self) -> int:
        """How many times the keyframe store hit ``max_keyframes`` and was
        distance-thinned (0 = the cap was never reached)."""
        return (self._kf_cfg or {}).get("thinning_events", 0)

    def get_keyframes(self):
        """Returns ``(positions [K, cap, D], masks [K, cap], poses [K])``
        padded to a common capacity (tensors on the mapper's device, numpy
        poses), or None before the first keyframe."""
        if not self._keyframes:
            return None
        cap = max(int(p.shape[0]) for p, _, _ in self._keyframes)
        pos, msk, poses = [], [], []
        for p, m, T in self._keyframes:
            pad = cap - int(p.shape[0])
            pos.append(torch.cat([p, p.new_zeros((pad, p.shape[1]))]))
            msk.append(torch.cat([m, m.new_zeros((pad,))]))
            poses.append(T)
        return torch.stack(pos), torch.stack(msk), np.stack(poses)

    def refine_trajectory(self, min_index_gap: int = 5,
                          max_dist: float = 8.0, min_overlap: float = 0.4,
                          match_max_dist: float = 2.0,
                          normal_radius: float = 1.0, icp_iters: int = 10,
                          gn_iters: int = 10, max_rms: float = 0.3):
        """Pose-graph refinement over the recorded keyframes: sequential
        odometry edges + loop-closure registrations of the candidate pairs,
        dense Gauss-Newton solve (``slam/pose_graph.py``).

        Returns ``(poses_before [K], poses_after [K], info)`` where info
        holds the closure edges and per-iteration costs.  Requires
        ``enable_keyframes()`` and >= 3 recorded keyframes."""
        from .slam.pose_graph import (
            sequential_edges, detect_loop_closures_batched,
            optimize_pose_graph)
        self.drain()
        kf = self.get_keyframes()
        if kf is None or kf[2].shape[0] < 3:
            raise RuntimeError("refine_trajectory: need >= 3 keyframes "
                               "(call enable_keyframes() before mapping)")
        kf_pos, kf_mask, poses = kf
        ei, ej, Z = sequential_edges(poses)
        w = [1.0] * len(ei)
        lei, lej, lZ, lw = detect_loop_closures_batched(
            kf_pos, kf_mask, poses, min_index_gap=min_index_gap,
            max_dist=max_dist, min_overlap=min_overlap,
            match_max_dist=match_max_dist, iters=icp_iters,
            normal_radius=normal_radius, max_rms=max_rms)
        if lei:
            ei = list(ei) + lei
            ej = list(ej) + lej
            Z = np.concatenate([Z, lZ])
            w = w + lw
        opt, costs = optimize_pose_graph(poses, ei, ej, Z, w,
                                         iters=gn_iters, device=self.device)
        info = {"loop_closures": list(zip(lei, lej)), "costs": costs,
                "n_edges": len(ei)}
        return poses, opt, info

    # ------------------------------------------------------------- accessors
    def get_map(self):
        self.drain()
        if self._sharded is not None:
            return self._sharded.get_map()
        return self.map.get_global_point_cloud()

    def set_map(self, new_map):
        self.drain()
        if self._sharded is not None:
            self._sharded.set_map(new_map)
        else:
            self.map.set_global_point_cloud(new_map)
        self.trajectory.clear()

    def get_new_local_map(self):
        if self._sharded is not None:
            # consume-once gather of the ranks' blocks: a map-sized
            # transfer, for publishing cadence
            return self._sharded.get_new_local_point_cloud()
        self._drain_fused()
        return self.map.get_new_local_point_cloud()

    @property
    def pose(self) -> Optional[np.ndarray]:
        return self.get_pose()

    @pose.setter
    def pose(self, value) -> None:
        self._pose = None if value is None else np.asarray(value)
        self._live = None

    def get_pose(self) -> Optional[np.ndarray]:
        """The latest corrected pose; for a scan still in flight this waits
        for its solve (not for its merge)."""
        if self._sharded is not None:
            return (None if self._sharded.pose is None
                    else self._sharded.get_pose())
        if self._live is not None:
            return self._live.get()["pose"].numpy().copy()
        return None if self._pose is None else np.asarray(self._pose)

    def get_is_mapping(self) -> bool:
        return self.is_mapping

    def set_is_mapping(self, value: bool):
        self.is_mapping = bool(value)

    def get_trajectory(self) -> Trajectory:
        return self.trajectory

    def shutdown(self):
        self.drain()
        if self._sharded is not None:
            self._sharded.shutdown()
            return
        if self._map_update_future is not None:
            self._map_update_future.result()
            self._map_update_future = None
        if self._executor is not None:
            self._executor.shutdown(wait=True)
        self.map.shutdown()
