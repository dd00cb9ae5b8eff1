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

The first scan (an empty map) takes the stepwise bootstrap path; every later
scan runs :class:`~norlab_icp_mapper_tpu_torch.fused.FusedScanStep`, unless
the config has a BoundTransformationChecker: that one throws on violation,
which only the stepwise path can do.  The
map's capacity is managed in the simple form: the count is read once per
merged scan and the buffer grows to ``bucket_capacity(count + headroom)``
with one whole scan of headroom.

Not ported yet (each raises ``NotImplementedError`` by name):
``is_online=True``, ``mesh=``, keyframes and ``refine_trajectory``.  The
pipelined mirror harvest, adaptive headroom, buffer shrink and overflow
re-merge of the reference's host loop are not ported either; this facade
reads the map count after each merge instead.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch
import yaml

from . import se3
from .draws import DrawSource, resolve_device
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


class Mapper:
    def __init__(self, config: Union[str, Dict[str, Any], None],
                 is_3d: bool = True, is_online: bool = False,
                 is_mapping: bool = True,
                 save_map_cells_on_hard_drive: bool = False,
                 seed: int = 0,
                 device: Union[str, torch.device, None] = "cuda",
                 draw_source: Optional[Callable[[str, int],
                                                torch.Tensor]] = None,
                 mesh=None):
        """``device`` is where the clouds live and the kernels run; it
        defaults to the card and raises if there is none (pass
        ``device="cpu"`` to run on the CPU, as the tests do).

        ``seed`` seeds the generator behind every random draw (random
        sampling, octree tie-breaks); ``draw_source(site, n) -> Tensor``
        replaces that generator with the caller's own draws (see
        ``draws.py``)."""
        if is_online:
            raise NotImplementedError(
                "Mapper(is_online=True) (the register/merge split and the "
                "map-update thread) is not ported yet")
        if mesh is not None:
            raise NotImplementedError(
                "Mapper(mesh=...) (the multi-device sharded map) is not "
                "ported yet")
        self.device = resolve_device(device)
        self.is_3d = is_3d
        self.dim = 3 if is_3d else 2
        self.is_online = False
        self.is_mapping = is_mapping
        self.draws = DrawSource(seed, self.device, draw_source)
        self.timer = PhaseTimer()
        self.icp = ICPEngine(config=None, dim=self.dim)
        self.map = Map(is_3d, False, save_map_cells_on_hard_drive, self.icp,
                       device=self.device)
        self.trajectory = Trajectory(3 if is_3d else 2)
        self.pose: Optional[np.ndarray] = None

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

        self._fused = FusedScanStep(self)
        self._meta = None  # host state of the fused step
        self._epoch_ns: Optional[int] = None

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
        return self._input_all.apply(scan.to(self.device), self.draws)

    def process_input(self, filtered_scan_in_sensor_frame: PointBatch,
                      estimated_pose: np.ndarray, timestamp_ns: int,
                      scan_valid_hint: Optional[int] = None) -> None:
        """Reference ``Mapper.cpp:194-238``.

        ``scan_valid_hint``: optional upper bound on the scan's valid point
        count (the loader knows it pre-padding); tightens map-buffer
        headroom sizing.  The bootstrap scan (empty map) takes the stepwise
        path; every later scan runs the fused per-scan step.
        """
        estimated_pose = np.asarray(estimated_pose, dtype=np.float32)
        scan = filtered_scan_in_sensor_frame.to(self.device)
        if self._epoch_ns is None:
            self._epoch_ns = int(timestamp_ns)
        # lpm's bound checker THROWS on violation; only the stepwise path
        # can raise host-side (the engine's __call__ reproduces it)
        if (self.icp.bound_checker is None
                and not self.map.first_pose_update
                and not self.map.is_local_point_cloud_empty()):
            self._process_input_fused(scan, estimated_pose, timestamp_ns,
                                      scan_valid_hint)
            return

        self._meta = None
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

        self.pose = np.asarray(corrected, dtype=np.float32)
        self.trajectory.add_pose(self.pose, timestamp_ns)

    # ---------------------------------------------------- fused hot path
    def _process_input_fused(self, scan: PointBatch,
                             estimated_pose: np.ndarray, timestamp_ns: int,
                             scan_valid_hint: Optional[int] = None) -> None:
        """One fused step per scan, then host bookkeeping."""
        hint = int(scan_valid_hint) if scan_valid_hint else scan.capacity
        headroom = max(1, self.map.merge_headroom_scans()) * hint
        count = self.map.known_count()
        if count + headroom > self.map.local.capacity:
            # the padded rows change the reference's shape: the engine
            # pads its reference alike and rebuilds the matcher's pack
            self.map.grow_local(bucket_capacity(count + headroom))

        if self._meta is None:
            # rebase the f32 session epoch so in-step relative seconds stay
            # small no matter how long the mapper has been alive
            if np.isfinite(self.last_time_map_was_updated):
                self._epoch_ns = int(self.last_time_map_was_updated)
            last_t = self.last_time_map_was_updated
            last_t_s = ((last_t - self._epoch_ns) * 1e-9
                        if np.isfinite(last_t) else -np.inf)
            pose = (self.pose if self.pose is not None
                    else np.eye(self.dim + 1, dtype=np.float32))
            bufs, self._meta = self._fused.init_state(
                self.map.local, self.icp._ref, pose,
                self.last_pose_where_map_was_updated, last_t_s)
        else:
            bufs = {"map": self.map.local,
                    "ref_pack": self.icp._ref_pack}
            if self._fused.has_ref:
                bufs["ref"] = self.icp._ref

        # f32 seconds relative to the session epoch (the delay gate's
        # operand); the authoritative merge timestamps are tracked below in
        # exact integer ns
        stamp_s = np.float32((int(timestamp_ns) - self._epoch_ns) * 1e-9)
        new_bufs, self._meta, aux = self._fused(
            bufs, self._meta, scan, estimated_pose, stamp_s, self.is_mapping)

        self.overlap = aux["overlap"]
        self.last_iterations = aux["iterations"]
        self.pose = self._meta["pose"].numpy().copy()
        self.trajectory.add_pose(self.pose, timestamp_ns)
        if aux["merged"]:
            self.map.local = new_bufs["map"]
            self.map._known_count = int(new_bufs["map"].count())  # the read
            self.map.new_local_available = True
            self.icp._ref = new_bufs.get("ref", new_bufs["map"])
            self.icp._ref_pack = new_bufs["ref_pack"]
            self.last_time_map_was_updated = int(timestamp_ns)
            self.last_pose_where_map_was_updated = self.pose
        # rolling window, driven by the corrected pose
        self.map.update_pose(self.pose)

    def drain(self) -> None:
        """Block until all device work of the scans fed so far is done and
        host bookkeeping is current.  Host bookkeeping is current after
        every ``process_input`` here; this only waits for the device."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if not isinstance(self.overlap, float):
            self.overlap = float(self.overlap)

    def _should_update_map(self, now_ns: int, current_pose: np.ndarray,
                           overlap: float) -> bool:
        """Reference ``Mapper.cpp:240-272``."""
        if not self.is_mapping:
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
        """Reference ``Mapper.cpp:274-288``."""
        self.last_time_map_was_updated = timestamp_ns
        self.last_pose_where_map_was_updated = np.asarray(pose)
        self.map.update_local_point_cloud(scan, pose, self.post_filters,
                                          self.draws, scan_valid_hint)

    # ------------------------------------------------------------ keyframes
    def enable_keyframes(self, *args, **kwargs):
        raise NotImplementedError(
            "Mapper.enable_keyframes (keyframe capture for the pose graph) "
            "is not ported yet")

    def refine_trajectory(self, *args, **kwargs):
        raise NotImplementedError(
            "Mapper.refine_trajectory (pose-graph refinement) is not ported "
            "yet")

    # ------------------------------------------------------------- accessors
    def get_map(self):
        self.drain()
        return self.map.get_global_point_cloud()

    def set_map(self, new_map):
        self.drain()
        self._meta = None
        self.map.set_global_point_cloud(new_map)
        self.trajectory.clear()

    def get_new_local_map(self):
        return self.map.get_new_local_point_cloud()

    def get_pose(self) -> Optional[np.ndarray]:
        return None if self.pose is None else np.asarray(self.pose)

    def get_is_mapping(self) -> bool:
        return self.is_mapping

    def set_is_mapping(self, value: bool):
        self.is_mapping = bool(value)

    def get_trajectory(self) -> Trajectory:
        return self.trajectory

    def shutdown(self):
        self.drain()
