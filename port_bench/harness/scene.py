"""The deployment's data, made on the card from the seed: a ray-cast lidar
patrolling a closed loop through a hall with boxes, and pose priors.

Everything comes from the configuration file's ``sensor``, ``scene``,
``trajectory`` and ``priors``; a seed draws the range noise (a
``torch.Generator`` on the card) and the priors' SE(3) noise (numpy).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


def rot_z(yaw: float) -> np.ndarray:
    c, s = math.cos(yaw), math.sin(yaw)
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    return T


@dataclass
class Loop:
    """A rounded rectangle, walked counter-clockwise from its first corner
    at constant speed."""
    corners: np.ndarray  # [4, 2]: (x0, y0), (x1, y0), (x1, y1), (x0, y1)
    radius: float

    @property
    def length(self) -> float:
        (x0, y0), (x1, _), (_, y1) = self.corners[0], self.corners[1], \
            self.corners[2]
        r = self.radius
        return 2 * (x1 - x0 - 2 * r) + 2 * (y1 - y0 - 2 * r) + 2 * math.pi * r

    def at(self, s: float):
        """``(x, y, heading)`` at arc length ``s``."""
        (x0, y0), (x1, _), (_, y1) = self.corners[0], self.corners[1], \
            self.corners[2]
        r = self.radius
        s = s % self.length
        # straight legs and quarter arcs, each as (length, function)
        legs = [
            (x1 - x0 - 2 * r, lambda u: (x0 + r + u, y0, 0.0)),
            (math.pi * r / 2, lambda u: self._arc(x1 - r, y0 + r, -90, u)),
            (y1 - y0 - 2 * r, lambda u: (x1, y0 + r + u, 90.0)),
            (math.pi * r / 2, lambda u: self._arc(x1 - r, y1 - r, 0, u)),
            (x1 - x0 - 2 * r, lambda u: (x1 - r - u, y1, 180.0)),
            (math.pi * r / 2, lambda u: self._arc(x0 + r, y1 - r, 90, u)),
            (y1 - y0 - 2 * r, lambda u: (x0, y1 - r - u, 270.0)),
            (math.pi * r / 2, lambda u: self._arc(x0 + r, y0 + r, 180, u)),
        ]
        for length, f in legs:
            if s <= length:
                x, y, h = f(s)
                return x, y, math.radians(h)
            s -= length
        x, y, h = legs[-1][1](legs[-1][0])
        return x, y, math.radians(h)

    def _arc(self, cx, cy, start_deg, u):
        a = math.radians(start_deg) + u / self.radius
        return (cx + self.radius * math.cos(a), cy + self.radius * math.sin(a),
                math.degrees(a) + 90.0)


class Scene:
    """The configuration's sensor, hall, loop and prior noise."""

    def __init__(self, cfg: dict, device):
        self.device = torch.device(device)
        sensor, scene, traj = cfg["sensor"], cfg["scene"], cfg["trajectory"]
        self.beams, self.columns = sensor["beams"], sensor["columns"]
        self.rate_hz = float(sensor["rate_hz"])
        self.noise = float(sensor["range_noise_m"])
        self.height = float(sensor["height_m"])
        lo, hi = sensor["elevation_deg"]
        el = np.deg2rad(np.linspace(lo, hi, self.beams))
        az = np.linspace(-np.pi, np.pi, self.columns, endpoint=False)
        el_g, az_g = np.meshgrid(el, az, indexing="ij")
        dirs = np.stack([np.cos(el_g) * np.cos(az_g),
                         np.cos(el_g) * np.sin(az_g), np.sin(el_g)], -1)
        self.dirs = torch.as_tensor(dirs.reshape(-1, 3), device=self.device)
        self.hall = torch.as_tensor(scene["hall"], dtype=torch.float64,
                                    device=self.device)  # [3, 2]
        self.boxes = torch.as_tensor(scene["boxes"], dtype=torch.float64,
                                     device=self.device)  # [B, 6]
        self.world = rot_z(math.radians(scene["yaw_deg"]))
        self.loop = Loop(np.asarray(traj["corners"], float),
                         float(traj["corner_radius_m"]))
        self.step_m = float(traj["speed_mps"]) / self.rate_hz
        self.sigma_t = float(cfg["priors"]["sigma_t_m"])
        self.sigma_r = math.radians(cfg["priors"]["sigma_r_deg"])

    @property
    def rays(self) -> int:
        return self.beams * self.columns

    @property
    def scans_per_lap(self) -> int:
        return int(round(self.loop.length / self.step_m))

    def true_pose(self, j: int) -> np.ndarray:
        """World pose (f32 4x4) of scan ``j``: the hall frame turned by the
        scene's yaw."""
        return (self.world @ self._hall_pose(j)).astype(np.float32)

    def _hall_pose(self, j: int) -> np.ndarray:
        x, y, h = self.loop.at(j * self.step_m)
        P = rot_z(h)
        P[:3, 3] = [x, y, self.height]
        return P

    def ray_cast(self, indices, generator: torch.Generator) -> torch.Tensor:
        """f32[S, rays, 3] scans (sensor frame) of the given scan indices:
        first hits of the rays on the hall's walls from inside or on a box
        from outside, plus Gaussian range noise."""
        P = torch.as_tensor(np.stack([self._hall_pose(j) for j in indices]),
                            device=self.device)  # [S, 4, 4] float64
        origin = P[:, None, :3, 3]  # [S, 1, 3]
        d = torch.einsum("rc,skc->srk", self.dirs, P[:, :3, :3])
        inv = 1.0 / d
        t1 = (self.hall[:, 0] - origin) * inv
        t2 = (self.hall[:, 1] - origin) * inv
        t_hit = torch.maximum(t1, t2).amin(-1)
        for b in self.boxes:
            lo, hi = b[0::2], b[1::2]
            a1, a2 = (lo - origin) * inv, (hi - origin) * inv
            near = torch.minimum(a1, a2).amax(-1)
            far = torch.maximum(a1, a2).amin(-1)
            hit = (near <= far) & (near > 0) & (near < t_hit)
            t_hit = torch.where(hit, near, t_hit)
        t_hit = t_hit + self.noise * torch.randn(
            t_hit.shape, generator=generator, device=self.device,
            dtype=torch.float64)
        return (self.dirs[None] * t_hit[..., None]).float()

    @staticmethod
    def with_error(pose: np.ndarray, error: np.ndarray) -> np.ndarray:
        """``pose`` with the error ``perturb`` drew on the identity: its
        rotation left-multiplied, its shift added."""
        out = pose.astype(np.float64).copy()
        out[:3, :3] = error[:3, :3] @ out[:3, :3]
        out[:3, 3] += error[:3, 3]
        return out.astype(np.float32)

    def perturb(self, pose: np.ndarray, rng: np.random.Generator):
        """Left-multiplied SE(3) noise: per-axis sigmas of the prior."""
        w = rng.normal(scale=self.sigma_r / math.sqrt(3), size=3)
        th = np.linalg.norm(w)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        R = np.eye(3) + (np.sin(th) / th) * K + \
            ((1 - np.cos(th)) / th ** 2) * K @ K
        out = pose.astype(np.float64).copy()
        out[:3, :3] = R @ out[:3, :3]
        out[:3, 3] += rng.normal(scale=self.sigma_t / math.sqrt(3), size=3)
        return out.astype(np.float32)
