"""SE(3)/SE(2) rigid-transform utilities (PyTorch, float32).

Apply a homogeneous (D+1)x(D+1) transform to point positions and rotate
covariant descriptors (normals), plus the exp/log maps the Gauss-Newton
minimizer needs.  Every function works on whatever device its arguments
lie on; ``apply`` and ``apply_points`` move a transform that lies on
another device than the points (the Mapper's poses live on the host, the
clouds and the ICP loop's running transform on the card).
"""
from __future__ import annotations

import torch

__all__ = [
    "apply", "apply_points", "exp_se3", "log_se3", "exp_se2",
    "quat_to_rot", "compose", "inverse", "identity",
]


def identity(dim: int = 3, device="cpu") -> torch.Tensor:
    return torch.eye(dim + 1, dtype=torch.float32, device=device)


def inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a rigid homogeneous transform."""
    d = T.shape[-1] - 1
    R = T[..., :d, :d]
    t = T[..., :d, d]
    Rt = R.transpose(-1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    top = torch.cat([Rt, ti[..., None]], dim=-1)
    bottom = torch.zeros_like(T[..., :1, :])
    # fill_, not `= 1.0`: a Python scalar assigned to a 0-d view is copied
    # from the host, and the host waits for the card's stream
    bottom[..., 0, d].fill_(1.0)
    return torch.cat([top, bottom], dim=-2)


def compose(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    return A @ B


def apply_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Apply (D+1)x(D+1) transform T to points [N, D]."""
    d = points.shape[-1]
    T = T.to(points.device)
    R = T[:d, :d]
    t = T[:d, d]
    return points @ R.T + t


_COVARIANT = ("normals", "observationDirections")


def apply(T: torch.Tensor, batch):
    """Transform a PointBatch: positions map affinely; ``normals`` (and any
    descriptor listed in ``_COVARIANT``) rotate."""
    d = batch.dim
    T = T.to(batch.positions.device)
    R = T[:d, :d]
    new_pos = apply_points(T, batch.positions)
    desc = dict(batch.descriptors)
    for name in _COVARIANT:
        if name in desc and desc[name].shape[1] == d:
            desc[name] = desc[name] @ R.T
    return batch.replace(positions=new_pos, descriptors=desc)


def _skew(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[0], w[1], w[2]
    z = torch.zeros((), dtype=w.dtype, device=w.device)
    return torch.stack([torch.stack([z, -wz, wy]),
                        torch.stack([wz, z, -wx]),
                        torch.stack([-wy, wx, z])])


def exp_se3(xi: torch.Tensor) -> torch.Tensor:
    """SE(3) exponential map. ``xi = [v(3), w(3)]`` -> 4x4 transform.

    Rodrigues with small-angle Taylor branches (``torch.where``), so it is
    well defined at theta=0."""
    v, w = xi[:3], xi[3:]
    theta2 = torch.dot(w, w)
    small = theta2 < 1e-4  # theta < 0.01: Taylor beats f32 trig cancellation
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    W = _skew(w)
    W2 = W @ W
    half = 0.5 * theta_safe
    A = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta_safe) / theta_safe)
    # half-angle form: 1 - cos t = 2 sin^2(t/2), cancellation-free in f32
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    2.0 * torch.sin(half) * torch.sin(half) / theta2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - A) / theta2_safe)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A * W + B * W2
    V = eye + B * W + C * W2
    t = V @ v
    T = torch.eye(4, dtype=xi.dtype, device=xi.device)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


def log_se3(T: torch.Tensor) -> torch.Tensor:
    """SE(3) log map: 4x4 -> [v(3), w(3)]. Small-angle safe."""
    R = T[:3, :3]
    t = T[:3, 3]
    # angle via atan2(sin, cos): well-conditioned at theta~0, unlike arccos
    w_hat = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0],
                         R[1, 0] - R[0, 1]])
    s2 = torch.dot(w_hat, w_hat)
    small = s2 < 4e-4  # theta < 0.01
    one = torch.ones_like(s2)
    s2_safe = torch.where(small, one, s2)
    sin_theta = 0.5 * torch.sqrt(s2_safe)
    cos_theta = torch.clamp((torch.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta_big = torch.atan2(sin_theta, cos_theta)
    theta2 = torch.where(small, 0.25 * s2, theta_big * theta_big)
    theta_safe = torch.where(small, one, theta_big)
    scale = torch.where(small, 0.5 + theta2 / 12.0,
                        theta_safe / (2.0 * torch.sin(theta_safe)))
    w = scale * w_hat
    W = _skew(w)
    W2 = W @ W
    half = 0.5 * theta_safe
    A = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta_safe) / theta_safe)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    2.0 * torch.sin(half) * torch.sin(half)
                    / (theta_safe * theta_safe))
    # V^{-1} = I - W/2 + (1/theta^2)(1 - A/(2B)) W^2
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / (theta_safe * theta_safe))
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * W + coef * W2
    v = Vinv @ t
    return torch.cat([v, w])


def exp_se2(xi: torch.Tensor) -> torch.Tensor:
    """SE(2) exponential map. ``xi = [vx, vy, w]`` -> 3x3 transform."""
    v = xi[:2]
    w = xi[2]
    c, s = torch.cos(w), torch.sin(w)
    R = torch.stack([torch.stack([c, -s]), torch.stack([s, c])])
    small = torch.abs(w) < 1e-2
    w_safe = torch.where(small, torch.ones_like(w), w)
    A = torch.where(small, 1.0 - w * w / 6.0, torch.sin(w_safe) / w_safe)
    B = torch.where(small, w / 2.0,
                    2.0 * torch.sin(0.5 * w_safe) * torch.sin(0.5 * w_safe)
                    / w_safe)
    V = torch.stack([torch.stack([A, -B]), torch.stack([B, A])])
    t = V @ v
    T = torch.eye(3, dtype=xi.dtype, device=xi.device)
    T[:2, :2] = R
    T[:2, 2] = t
    return T


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> 3x3 rotation (normalizes first; ROS
    order)."""
    q = q / torch.linalg.norm(q)
    x, y, z, w = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)]),
    ])
