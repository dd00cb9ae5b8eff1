"""ROS-PoseStamped-style trajectory CSV reader.

Re-implements the parsing done by the reference offline example
(``examples/build_map_from_scans_and_trajectory.cpp:15-173``): a CSV with
columns ``header.stamp.sec``, ``header.stamp.nanosec``,
``pose.pose.position.{x,y,z}`` and ``pose.pose.orientation.{x,y,z,w}``
(extra columns like covariance/twist are ignored).  Each row becomes a
4x4 homogeneous pose; scans are matched to rows 1:1 by order, with no
interpolation (reference ``docs/RunningExample.md:30-33``).  The port's own
copy of the JAX package's module (numpy only).
"""
from __future__ import annotations

import csv
from typing import List, Tuple

import numpy as np

__all__ = ["read_trajectory_csv"]


def _quat_to_rot_np(x, y, z, w):
    n = np.sqrt(x * x + y * y + z * z + w * w)
    x, y, z, w = x / n, y / n, z / n, w / n
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
        [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
        [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
    ], dtype=np.float32)


def read_trajectory_csv(path: str) -> List[Tuple[np.ndarray, int]]:
    """Returns list of ``(pose 4x4 float32, stamp_ns int)`` per row."""
    out = []
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        for row in reader:
            sec = int(row["header.stamp.sec"])
            nsec = int(row["header.stamp.nanosec"])
            px = float(row["pose.pose.position.x"])
            py = float(row["pose.pose.position.y"])
            pz = float(row["pose.pose.position.z"])
            qx = float(row["pose.pose.orientation.x"])
            qy = float(row["pose.pose.orientation.y"])
            qz = float(row["pose.pose.orientation.z"])
            qw = float(row["pose.pose.orientation.w"])
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = _quat_to_rot_np(qx, qy, qz, qw)
            T[:3, 3] = (px, py, pz)
            out.append((T, sec * 1_000_000_000 + nsec))
    return out
