"""Trajectory quality metrics (ATE, RPE), in numpy.

Conventions follow the standard TUM evaluation: ATE = RMSE of translational
differences after (optional) rigid alignment; RPE = RMSE of relative-pose
deltas over a fixed step.  The same functions as the JAX package's
``utils/metrics.py``, which imports no JAX: the port keeps its own copy.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

__all__ = ["ate", "rpe", "align_umeyama"]


def align_umeyama(est: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Best rigid transform mapping est positions onto ref ([N, D])."""
    mu_e = est.mean(0)
    mu_r = ref.mean(0)
    H = (est - mu_e).T @ (ref - mu_r)
    U, _, Vt = np.linalg.svd(H)
    d = est.shape[1]
    S = np.eye(d)
    S[-1, -1] = np.sign(np.linalg.det(Vt.T @ U.T))
    R = Vt.T @ S @ U.T
    t = mu_r - R @ mu_e
    T = np.eye(d + 1)
    T[:d, :d] = R
    T[:d, d] = t
    return T


def ate(est_positions: np.ndarray, ref_positions: np.ndarray,
        align: bool = False) -> float:
    """RMSE of translational error between matched trajectory positions."""
    est = np.asarray(est_positions, np.float64)
    ref = np.asarray(ref_positions, np.float64)
    if est.shape != ref.shape:
        raise ValueError(f"ate: shapes differ, {est.shape} and {ref.shape}")
    if align and est.shape[0] >= 3:
        T = align_umeyama(est, ref)
        d = est.shape[1]
        est = est @ T[:d, :d].T + T[:d, d]
    err = est - ref
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def rpe(est_poses: Sequence[np.ndarray], ref_poses: Sequence[np.ndarray],
        step: int = 1) -> Tuple[float, float]:
    """Relative pose error: (trans RMSE, rot RMSE rad) over ``step`` deltas."""
    t_errs, r_errs = [], []
    for i in range(len(est_poses) - step):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + step]
        dr = np.linalg.inv(ref_poses[i]) @ ref_poses[i + step]
        e = np.linalg.inv(dr) @ de
        d = e.shape[0] - 1
        t_errs.append(np.linalg.norm(e[:d, d]))
        c = np.clip((np.trace(e[:d, :d]) - (d - 2)) / 2.0, -1, 1)
        r_errs.append(np.arccos(c))
    if not t_errs:
        return 0.0, 0.0
    return (float(np.sqrt(np.mean(np.square(t_errs)))),
            float(np.sqrt(np.mean(np.square(r_errs)))))
