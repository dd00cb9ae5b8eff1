"""Trajectory recorder: append-only pose + timestamp log.

Parity with reference ``Trajectory.{h,cpp}``: ``addPose(pose, stamp)``,
``save(filename)`` (positions as features, rotation columns as
``orientation{X,Y,Z}`` descriptors, nanosecond time channel —
``Trajectory.cpp:15-53``), ``clear()``.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from .io.vtk import write_vtk

__all__ = ["Trajectory"]


class Trajectory:
    def __init__(self, dimension: int = 3):
        self.dimension = dimension
        self._poses: List = []  # numpy arrays, or device tensors (lazy)
        self.timestamps: List[int] = []  # nanoseconds
        self._has_device = False

    def add_pose(self, pose, timestamp_ns: int) -> None:
        """Append a pose.  A tensor on a card is kept as it is and fetched
        lazily, with every other such pose in one transfer, on the first
        host access (the pipelined Mapper appends each scan's pose without
        waiting for the card); anything else ``np.asarray`` accepts is
        copied."""
        if isinstance(pose, torch.Tensor) and pose.device.type != "cpu":
            self._has_device = True
        else:
            pose = np.array(pose, dtype=np.float32)
        self._poses.append(pose)
        self.timestamps.append(int(timestamp_ns))

    @property
    def poses(self) -> List[np.ndarray]:
        if self._has_device:
            on_card = [i for i, p in enumerate(self._poses)
                       if isinstance(p, torch.Tensor)]
            host = torch.stack([self._poses[i] for i in on_card]).cpu()
            for i, p in zip(on_card, host.numpy()):
                self._poses[i] = p.astype(np.float32)
            self._has_device = False
        return self._poses

    def clear(self) -> None:
        self._poses = []
        self.timestamps = []
        self._has_device = False

    def __len__(self) -> int:
        return len(self._poses)

    def positions(self) -> np.ndarray:
        d = self.dimension
        if not self._poses:
            return np.zeros((0, d), np.float32)
        return np.stack([p[:d, d] for p in self.poses])

    def save(self, filename: str) -> None:
        """Write poses as a VTK point file (reference ``Trajectory.cpp:15-53``:
        positions as features, rotation columns as orientation descriptors,
        time channel).

        Timestamps are nanosecond epoch integers; a single float32 (or even
        float64) channel cannot hold 2026-epoch nanoseconds exactly, so the
        time channel is split ROS-style into ``t_sec`` + ``t_nsec`` double
        columns — both exactly representable, asserting lossless round-trip
        (see ``Trajectory.load``)."""
        d = self.dimension
        n = len(self.poses)
        pos = self.positions()
        desc = {}
        axes = ["orientationX", "orientationY", "orientationZ"][:d]
        for col, name in enumerate(axes):
            desc[name] = np.stack([p[:d, col] for p in self.poses]) if n else \
                np.zeros((0, d), np.float32)
        t = np.asarray(self.timestamps, np.int64)
        desc["t_sec"] = (t // 1_000_000_000).astype(np.float64)[:, None]
        desc["t_nsec"] = (t % 1_000_000_000).astype(np.float64)[:, None]
        write_vtk(filename, pos, desc)

    @staticmethod
    def load(filename: str, dimension: int = 3) -> "Trajectory":
        """Round-trip reader for files written by :meth:`save` (exact ns)."""
        from .io.vtk import read_vtk
        pos, desc = read_vtk(filename)
        traj = Trajectory(dimension)
        n = pos.shape[0]
        if n == 0:
            return traj
        d = dimension
        axes = ["orientationX", "orientationY", "orientationZ"][:d]
        stamps = (desc["t_sec"][:, 0].astype(np.int64) * 1_000_000_000
                  + desc["t_nsec"][:, 0].astype(np.int64)) \
            if "t_sec" in desc else np.zeros(n, np.int64)
        for i in range(n):
            pose = np.eye(d + 1, dtype=np.float32)
            for col, name in enumerate(axes):
                pose[:d, col] = desc[name][i, :d]
            pose[:d, d] = pos[i, :d]
            traj.add_pose(pose, int(stamps[i]))
        return traj
