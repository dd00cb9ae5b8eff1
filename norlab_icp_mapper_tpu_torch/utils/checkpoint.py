"""Checkpoint / resume.

The mapper's checkpoint is map export/import (``get_map`` / ``set_map``)
plus the trajectory; restoring a map and switching mapping off gives
localization-only resume.  This module packages that into one artifact:

  ``save_checkpoint(path, mapper)`` writes a single ``.npz`` holding the
  global map cloud (positions + all descriptors), the current pose, the
  trajectory (poses + timestamps), and the update-condition state.
  ``load_checkpoint(path, mapper)`` restores all of it; pass
  ``localization_only=True`` to also freeze mapping.

The layout is the JAX package's (``utils/checkpoint.py``) key for key, so a
checkpoint written by either package loads into the other.
"""
from __future__ import annotations

import numpy as np

__all__ = ["save_checkpoint", "load_checkpoint"]

_RESERVED = ("pose", "traj_poses", "traj_stamps", "last_update_pose",
             "last_update_ns", "positions")


def save_checkpoint(path: str, mapper) -> None:
    cloud = mapper.get_map()
    arrays = {"positions": cloud["positions"]}
    for name, v in cloud.items():
        if name == "positions":
            continue
        if name in _RESERVED:
            raise ValueError(
                f"descriptor name collides with checkpoint key: {name}")
        arrays[name] = v
    tr = mapper.get_trajectory()
    pose = mapper.get_pose()
    arrays["pose"] = (pose if pose is not None
                      else np.eye(mapper.dim + 1, dtype=np.float32))
    poses = tr.poses
    arrays["traj_poses"] = (np.stack(poses) if poses
                            else np.zeros((0, mapper.dim + 1, mapper.dim + 1),
                                          np.float32))
    arrays["traj_stamps"] = np.asarray(tr.timestamps, np.int64)
    arrays["last_update_pose"] = np.asarray(
        mapper.last_pose_where_map_was_updated)
    # exact int64 ns: epoch nanoseconds (~1.7e18) exceed float64's 2^53
    # integer range; int64-min is the "never updated" (-inf) sentinel
    ns = mapper.last_time_map_was_updated
    arrays["last_update_ns"] = np.asarray(
        [np.iinfo(np.int64).min if not np.isfinite(ns) else int(ns)],
        np.int64)
    np.savez_compressed(path, **arrays)


def load_checkpoint(path: str, mapper, localization_only: bool = False) -> None:
    with np.load(path) as data:
        cloud = {"positions": data["positions"]}
        for name in data.files:
            if name not in _RESERVED:
                cloud[name] = data[name]
        mapper.set_map(cloud)  # clears the trajectory
        tr = mapper.get_trajectory()
        for pose, stamp in zip(data["traj_poses"], data["traj_stamps"]):
            tr.add_pose(pose, int(stamp))
        mapper.pose = data["pose"]
        mapper.last_pose_where_map_was_updated = data["last_update_pose"]
        raw = data["last_update_ns"]
    if raw.dtype.kind == "f":  # an artifact that stored float64 seconds-ns
        mapper.last_time_map_was_updated = float(raw[0])
    else:
        mapper.last_time_map_was_updated = (
            -np.inf if int(raw[0]) == np.iinfo(np.int64).min
            else int(raw[0]))
    if localization_only:
        mapper.set_is_mapping(False)
