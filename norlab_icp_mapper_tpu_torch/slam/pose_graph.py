"""Keyframe pose-graph refinement (Gauss-Newton on SE(3)/SE(2)).

Given keyframe poses and relative-pose constraints (sequential odometry +
loop closures from re-registering keyframe pairs), minimize

    sum_e w_e * || log( Z_e^-1 * (T_i^-1 * T_j) ) ||^2

over all node poses (node 0 gauge-fixed).  Small graphs (10^2..10^3
keyframes) solve densely: the Jacobian comes from ``torch.func.jacfwd`` over
the stacked residual, one GN step is a damped solve, iterated a fixed number
of times with annealed Geman-McClure weights.

On the card the loop-closure registrations search with ``ops.nn.nn1`` (the
``knn_brute`` kernel) and the keyframe normals come from
``ops.pca.radius_pca_normals`` (the ``radius_pca`` kernel).  The JAX package
vmaps the candidate pairs into one program; here the pairs run one after
another, each GN iteration one ``knn_brute`` launch.
"""
from __future__ import annotations

import warnings
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from .. import se3
from ..draws import resolve_device

__all__ = ["optimize_pose_graph", "sequential_edges", "detect_loop_closures",
           "detect_loop_closures_batched", "register_pairs_batched",
           "register_pairs_batched_plain", "keyframe_normals",
           "keyframe_insert"]


def keyframe_insert(keyframes: list, cfg: dict, scan_positions, scan_mask,
                    pose: np.ndarray, dim: int) -> bool:
    """Distance-gated keyframe insert with logarithmic thinning at the cap.

    Below ``max_keyframes`` this is the plain spacing gate; AT the cap the
    store is thinned to every second keyframe (endpoints kept) and
    ``min_distance`` doubles, so coverage stays full-trajectory with
    bounded memory.  Each thinning is counted in ``cfg["thinning_events"]``
    and warned.

    Returns True when the keyframe was stored.
    """
    if keyframes:
        last = keyframes[-1][2]
        if np.linalg.norm(pose[:dim, dim] - last[:dim, dim]) \
                < cfg["min_distance"]:
            return False
    if len(keyframes) >= cfg["max_keyframes"]:
        survivors = keyframes[::2]
        if (len(keyframes) - 1) % 2:  # keep the most recent endpoint
            survivors.append(keyframes[-1])
        keyframes[:] = survivors
        cfg["min_distance"] *= 2.0
        cfg["thinning_events"] = cfg.get("thinning_events", 0) + 1
        warnings.warn(
            f"keyframe store reached max_keyframes={cfg['max_keyframes']}: "
            f"thinned to every 2nd keyframe and doubled min_distance to "
            f"{cfg['min_distance']:.3g} m (thinning event "
            f"#{cfg['thinning_events']})")
        last = keyframes[-1][2]
        if np.linalg.norm(pose[:dim, dim] - last[:dim, dim]) \
                < cfg["min_distance"]:
            return False
    keyframes.append((scan_positions, scan_mask, pose))
    return True


# ----------------------------------------------------------------------------
# batched SE(3) / SE(2) maps, written without in-place writes so that
# torch.func.jacfwd can differentiate them (the formulas of ``se3.py``)
# ----------------------------------------------------------------------------

def _skew_b(w):
    z = torch.zeros_like(w[:, 0])
    return torch.stack([
        torch.stack([z, -w[:, 2], w[:, 1]], -1),
        torch.stack([w[:, 2], z, -w[:, 0]], -1),
        torch.stack([-w[:, 1], w[:, 0], z], -1)], -2)


def _homogeneous(R, t):
    top = torch.cat([R, t[:, :, None]], dim=-1)
    bottom = torch.cat([torch.zeros_like(t), torch.ones_like(t[:, :1])],
                       dim=-1)[:, None, :]
    return torch.cat([top, bottom], dim=-2)


def _exp_b(xi, dim):
    """``exp`` of each row of ``xi [n, dof]`` -> ``[n, dim+1, dim+1]``."""
    if dim == 2:
        v, w = xi[:, :2], xi[:, 2]
        c, s = torch.cos(w), torch.sin(w)
        R = torch.stack([torch.stack([c, -s], -1),
                         torch.stack([s, c], -1)], -2)
        small = torch.abs(w) < 1e-2
        w_safe = torch.where(small, torch.ones_like(w), w)
        A = torch.where(small, 1.0 - w * w / 6.0, torch.sin(w_safe) / w_safe)
        B = torch.where(small, w / 2.0,
                        2.0 * torch.sin(0.5 * w_safe)
                        * torch.sin(0.5 * w_safe) / w_safe)
        V = torch.stack([torch.stack([A, -B], -1),
                         torch.stack([B, A], -1)], -2)
        return _homogeneous(R, (V @ v[:, :, None])[:, :, 0])
    v, w = xi[:, :3], xi[:, 3:]
    theta2 = torch.sum(w * w, dim=1)
    small = theta2 < 1e-4
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    W = _skew_b(w)
    W2 = W @ W
    half = 0.5 * theta_safe
    A = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta_safe) / theta_safe)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    2.0 * torch.sin(half) * torch.sin(half) / theta2_safe)
    C = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (1.0 - A) / theta2_safe)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device)
    R = eye + A[:, None, None] * W + B[:, None, None] * W2
    V = eye + B[:, None, None] * W + C[:, None, None] * W2
    return _homogeneous(R, (V @ v[:, :, None])[:, :, 0])


def _inv_b(T):
    d = T.shape[-1] - 1
    Rt = T[:, :d, :d].transpose(1, 2)
    return _homogeneous(Rt, -(Rt @ T[:, :d, d:])[:, :, 0])


def _log_b(T, dim):
    """``log`` of each transform of ``T [E, dim+1, dim+1]`` -> ``[E, dof]``."""
    if dim == 2:
        R, t = T[:, :2, :2], T[:, :2, 2]
        w = torch.atan2(R[:, 1, 0], R[:, 0, 0])
        small = torch.abs(w) < 1e-5
        one = torch.ones_like(w)
        w_safe = torch.where(small, one, w)
        A = torch.where(small, 1.0 - w * w / 6.0, torch.sin(w) / w_safe)
        B = torch.where(small, w / 2.0, (1.0 - torch.cos(w)) / w_safe)
        det = torch.clamp(A * A + B * B, min=1e-12)
        vx = (A * t[:, 0] + B * t[:, 1]) / det
        vy = (-B * t[:, 0] + A * t[:, 1]) / det
        return torch.stack([vx, vy, w], dim=1)
    R, t = T[:, :3, :3], T[:, :3, 3]
    w_hat = torch.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                         R[:, 1, 0] - R[:, 0, 1]], dim=1)
    s2 = torch.sum(w_hat * w_hat, dim=1)
    small = s2 < 4e-4
    one = torch.ones_like(s2)
    s2_safe = torch.where(small, one, s2)
    sin_theta = 0.5 * torch.sqrt(s2_safe)
    tr = R[:, 0, 0] + R[:, 1, 1] + R[:, 2, 2]
    cos_theta = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    theta_big = torch.atan2(sin_theta, cos_theta)
    theta2 = torch.where(small, 0.25 * s2, theta_big * theta_big)
    theta_safe = torch.where(small, one, theta_big)
    scale = torch.where(small, 0.5 + theta2 / 12.0,
                        theta_safe / (2.0 * torch.sin(theta_safe)))
    w = scale[:, None] * w_hat
    W = _skew_b(w)
    W2 = W @ W
    half = 0.5 * theta_safe
    A = torch.where(small, 1.0 - theta2 / 6.0,
                    torch.sin(theta_safe) / theta_safe)
    B = torch.where(small, 0.5 - theta2 / 24.0,
                    2.0 * torch.sin(half) * torch.sin(half)
                    / (theta_safe * theta_safe))
    coef = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                       (1.0 - A / (2.0 * B)) / (theta_safe * theta_safe))
    eye = torch.eye(3, dtype=T.dtype, device=T.device)
    Vinv = eye - 0.5 * W + coef[:, None, None] * W2
    v = (Vinv @ t[:, :, None])[:, :, 0]
    return torch.cat([v, w], dim=1)


def _solve(poses0, ei, ej, Z, w, dim, iters, rot_weight=20.0):
    n = poses0.shape[0]
    dof = 6 if dim == 3 else 3
    f32, dev = torch.float32, poses0.device
    # rotational residuals (rad) must cost MORE than translational ones
    # (m): with equal weighting GN satisfies a loop closure by bending a few
    # early edges' rotations, which moves far-away nodes by (lever arm x
    # angle) metres.  rot_weight ~ sigma_t / sigma_r = 0.2 m / 0.01 rad.
    comp = torch.cat([torch.ones(dim, dtype=f32, device=dev),
                      torch.full((dof - dim,), rot_weight, dtype=f32,
                                 device=dev)])
    Z_inv = _inv_b(Z)

    def residuals(xi_flat, rw):
        Ts = _exp_b(xi_flat.reshape(n, dof), dim) @ poses0
        rel = _inv_b(Ts[ei]) @ Ts[ej]
        r = _log_b(Z_inv @ rel, dim)  # [E, dof]
        return (r * comp[None, :] * torch.sqrt(w * rw)[:, None]).reshape(-1)

    jac = torch.func.jacfwd(residuals)
    # gauge fix: freeze node 0
    gauge = torch.cat([torch.zeros(dof, dtype=f32, device=dev),
                       torch.ones((n - 1) * dof, dtype=f32, device=dev)])
    eye = torch.eye(n * dof, dtype=f32, device=dev)
    ones_w = torch.ones_like(w)

    def gn_step(xi_flat, delta2):
        # robust IRLS (Geman-McClure): a WRONG loop closure keeps a large
        # residual however the graph bends, and its weight collapses as
        # delta^2 / (delta^2 + e^2).  delta ANNEALS from the largest initial
        # edge residual down to 1: early iterations behave like plain GN (a
        # correct closure's residual IS the accumulated drift), late ones
        # release only the edges that stayed inconsistent.
        r_edge = residuals(xi_flat, ones_w).reshape(-1, dof)
        e2 = torch.sum(r_edge * r_edge, dim=1)
        rw = delta2 / (delta2 + e2)
        r = residuals(xi_flat, rw)
        J = jac(xi_flat, rw) * gauge[None, :]  # [E*dof, n*dof]
        JtJ = J.T @ J
        lam = 1e-6 + 1e-4 * torch.trace(JtJ) / (n * dof)
        dx = -torch.linalg.solve(JtJ + lam * eye, J.T @ r)
        return xi_flat + dx * gauge, torch.sum(r * r)

    xi = torch.zeros(n * dof, dtype=f32, device=dev)
    r0 = residuals(xi, ones_w).reshape(-1, dof)
    d2_hi = torch.clamp(torch.max(torch.sum(r0 * r0, dim=1)), min=1.0)
    s = torch.linspace(0.0, 1.0, max(iters, 2), dtype=f32,
                       device=dev)[:iters]
    delta2_sched = torch.exp(torch.log(d2_hi) * (1.0 - s))  # d2_hi -> 1
    costs = []
    for k in range(iters):
        xi, cost = gn_step(xi, delta2_sched[k])
        costs.append(cost)
    out = _exp_b(xi.reshape(n, dof), dim) @ poses0
    return out, (torch.stack(costs) if costs
                 else torch.zeros(0, dtype=f32, device=dev))


def optimize_pose_graph(
    poses: np.ndarray,  # [N, dim+1, dim+1]
    edges_i: Sequence[int],
    edges_j: Sequence[int],
    measurements: np.ndarray,  # [E, dim+1, dim+1]  Z: T_i^-1 T_j expected
    weights: Optional[Sequence[float]] = None,
    iters: int = 10,
    device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (optimized poses, per-iteration costs), as numpy."""
    dev = resolve_device(device)
    poses = np.asarray(poses, np.float32)
    dim = poses.shape[-1] - 1
    E = len(edges_i)
    w = np.ones((E,), np.float32) if weights is None else \
        np.asarray(weights, np.float32)
    t = lambda a, dt=torch.float32: torch.as_tensor(  # noqa: E731
        np.asarray(a), dtype=dt).to(dev)
    out, costs = _solve(t(poses), t(edges_i, torch.int64),
                        t(edges_j, torch.int64),
                        t(np.asarray(measurements, np.float32)), t(w),
                        dim=dim, iters=iters)
    return out.cpu().numpy(), costs.cpu().numpy()


def sequential_edges(poses: np.ndarray):
    """Odometry edges between consecutive keyframes (Z from the poses)."""
    n = poses.shape[0]
    ei = list(range(n - 1))
    ej = list(range(1, n))
    Z = np.stack([np.linalg.inv(poses[i]) @ poses[i + 1]
                  for i in range(n - 1)]).astype(np.float32)
    return ei, ej, Z


def _first_window(radius: float) -> int:
    """The first window of :func:`keyframe_normals`: the SurfaceNormal
    filter's."""
    return 2048 if radius <= 1.0 else 4096


def keyframe_normals(pos: torch.Tensor, msk: torch.Tensor,
                     radius: float = 1.0, min_knn: int = 5,
                     return_overflow: bool = False):
    """Per-keyframe surface normals, ``pos [K, cap, D]`` -> ``[K, cap, D]``.

    Each keyframe is centred on its masked mean and goes through
    ``ops.pca.radius_pca_normals`` (the ``radius_pca`` kernel on the card).
    A neighbourhood of fewer than ``min_knn`` points gets a ZERO normal, as
    in the JAX package (not the kernel's unit fallback).

    The kernel's window ``W`` is capped, the reference's neighbourhood is
    not: keyframes whose windows overflowed run again with ``W`` doubled
    until every overflow count is 0 (one host read per round; ``W`` reaches
    the cloud's capacity at worst, where nothing can overflow).  The first
    window is the SurfaceNormal filter's (2048 for a radius up to 1 m, else
    4096).  With
    ``return_overflow`` the result is ``(normals, overflow, W)``: each
    keyframe's final overflow count (numpy int64[K], all 0) and window.
    """
    from ..ops.pca import radius_pca_normals
    K, cap, _ = pos.shape
    r = float(radius)
    W0 = _first_window(r)
    out = torch.zeros_like(pos)
    overflow = np.zeros(K, np.int64)
    Ws = [min(W0, cap)] * K
    todo = list(range(K))
    while todo:
        ovs = []
        for k in todo:
            p, m = pos[k], msk[k]
            c = (torch.where(m[:, None], p, torch.zeros_like(p)).sum(0)
                 / torch.clamp(m.to(torch.float32).sum(), min=1.0))
            q = p - c
            cnt, _, nrm, ov = radius_pca_normals(q, q, m, m, max_radius=r,
                                                 q_tile=1024, W=Ws[k])
            out[k] = torch.where((cnt >= min_knn)[:, None], nrm,
                                 torch.zeros_like(nrm))
            ovs.append(ov.to(torch.int64))
        ov_h = torch.stack(ovs).cpu().numpy()  # the round's one read
        nxt = []
        for k, ov in zip(todo, ov_h):
            overflow[k] = ov
            if ov > 0:
                if Ws[k] >= cap:
                    raise RuntimeError(
                        "keyframe_normals: a window of the whole cloud "
                        "overflowed")
                Ws[k] = min(2 * Ws[k], cap)
                nxt.append(k)
        todo = nxt
    if return_overflow:
        return out, overflow, Ws
    return out


# the registrations' trimmed outlier rejection keeps this share of the pairs
_TRIM_RATIO = 0.7


def _register_pairs(read_pos, read_mask, ref_pos, ref_norm, ref_mask, rel0,
                    max_dist, iters, plain):
    """Point-to-plane registration of each candidate pair (reading j against
    keyframe i), ``iters`` GN iterations each.  Loop-closure pairs overlap
    only partially, so each iteration trims to the best ``_TRIM_RATIO`` of
    the matched pairs (lpm TrimmedDistOutlierFilter semantics); the
    returned overlap is measured before the trim."""
    from ..ops.nn import knn_plain, nn1, pack_refs
    C = read_pos.shape[0]
    dim = read_pos.shape[-1]
    dof = 6 if dim == 3 else 3
    dev = read_pos.device
    f32 = torch.float32
    mf = np.float32(max_dist)
    max_d2 = float(mf * mf)
    eye = torch.eye(dof, dtype=f32, device=dev)
    exp = se3.exp_se3 if dim == 3 else se3.exp_se2
    Ts, overlaps, rmss = [], [], []
    for c in range(C):
        rp, rmsk = read_pos[c], read_mask[c]
        fp, fn, fm = ref_pos[c], ref_norm[c], ref_mask[c]
        n_read = torch.clamp(rmsk.to(f32).sum(), min=1.0)
        pack = None if plain else pack_refs(fp, fm)
        T = rel0[c]
        overlap = rms = torch.zeros((), dtype=f32, device=dev)
        for _ in range(iters):
            p = se3.apply_points(T, rp)
            if plain:
                d2, idx = knn_plain(p, fp, rmsk, fm, 1)
                d2, idx = d2[:, 0], idx[:, 0]
            else:
                d2, idx = nn1(p, fp, rmsk, fm, pack=pack)
            w = (rmsk & (d2 <= max_d2)).to(f32)
            overlap = w.sum() / n_read
            # trimmed outlier rejection: the closest _TRIM_RATIO of the pairs
            d2m = torch.where(w > 0, d2, torch.full_like(d2, float("inf")))
            srt = torch.sort(d2m).values
            cut = torch.clamp((_TRIM_RATIO * w.sum()).to(torch.int64) - 1,
                              0, d2m.shape[0] - 1)
            w = w * (d2 <= srt.index_select(0, cut.reshape(1)))
            safe = torch.clamp(idx, min=0)
            q, qn = fp[safe], fn[safe]
            r = torch.sum(qn * (p - q), dim=1)
            # the trimmed point-to-plane RMS: the registration-quality gate
            rms = torch.sqrt(torch.sum(w * r * r)
                             / torch.clamp(w.sum(), min=1.0))
            if dim == 3:
                J = torch.cat([qn, torch.cross(p, qn, dim=1)], dim=1)
            else:
                c2 = p[:, 0] * qn[:, 1] - p[:, 1] * qn[:, 0]
                J = torch.cat([qn, c2[:, None]], dim=1)
            Jw = J * w[:, None]
            JtJ = Jw.T @ J
            Jtr = Jw.T @ r
            lam = 1e-3 * torch.trace(JtJ) / dof + 1e-6
            T = exp(-torch.linalg.solve_ex(JtJ + lam * eye, Jtr).result) @ T
        Ts.append(T)
        overlaps.append(overlap)
        rmss.append(rms)
    return torch.stack(Ts), torch.stack(overlaps), torch.stack(rmss)


def register_pairs_batched(read_pos, read_mask, ref_pos, ref_norm, ref_mask,
                           rel0, max_dist: float = 2.0, iters: int = 10):
    """Register C candidate pairs: reading j against keyframe i.

    All tensors lead with the candidate axis C.  ``rel0 [C, dim+1, dim+1]``
    is the initial relative guess ``T_i^-1 T_j``; returns ``(T [C, ...],
    overlap [C], rms [C])`` as tensors on the clouds' device, where ``T`` is
    the refined relative transform (the pose-graph measurement Z) and
    ``rms`` the final trimmed point-to-plane residual.  The nearest
    neighbours come from ``ops.nn.nn1``: on the card one ``knn_brute``
    launch per pair and GN iteration, ranked by exact ``sum((r - q)^2)``
    (the JAX package ranks by ``|p|^2 + |r|^2 - 2 p.r``).
    """
    rel0 = torch.as_tensor(np.asarray(rel0, np.float32)).to(read_pos.device)
    return _register_pairs(read_pos, read_mask, ref_pos, ref_norm, ref_mask,
                           rel0, max_dist, iters, plain=False)


def register_pairs_batched_plain(read_pos, read_mask, ref_pos, ref_norm,
                                 ref_mask, rel0, max_dist: float = 2.0,
                                 iters: int = 10):
    """:func:`register_pairs_batched` with the brute-force search's plain
    PyTorch version (``ops.nn.knn_plain``) on whatever device the tensors
    lie: the yardstick its kernel is held against."""
    rel0 = torch.as_tensor(np.asarray(rel0, np.float32)).to(read_pos.device)
    return _register_pairs(read_pos, read_mask, ref_pos, ref_norm, ref_mask,
                           rel0, max_dist, iters, plain=True)


def _candidates(poses, min_index_gap, max_dist):
    n = poses.shape[0]
    d = poses.shape[-1] - 1
    pos = poses[:, :d, d]
    return [(i, j) for i in range(n) for j in range(i + min_index_gap, n)
            if np.linalg.norm(pos[i] - pos[j]) <= max_dist]


def detect_loop_closures_batched(
    kf_pos: torch.Tensor,  # [K, cap, D] keyframe scans (sensor frame)
    kf_mask: torch.Tensor,  # [K, cap]
    poses: np.ndarray,  # [K, dim+1, dim+1]
    min_index_gap: int = 10, max_dist: float = 5.0,
    min_overlap: float = 0.5, match_max_dist: float = 2.0,
    iters: int = 10, normal_radius: float = 1.0,
    max_rms: float = 0.3,
):
    """Loop-closure detection: candidate gating (spatially close, far in
    index) on the host, then every candidate registered
    (:func:`register_pairs_batched`) against the normals of its keyframe
    (:func:`keyframe_normals`, computed for the keyframes that serve as a
    reference).  Accepted closures pass BOTH the overlap gate and the
    registration-quality gate (trimmed point-to-plane RMS <= ``max_rms``):
    a solve that slid to a false minimum can keep decent overlap but not a
    low residual, and one wrong closure poisons the whole graph.

    Returns ``(ei, ej, Z, weights)`` like ``detect_loop_closures``."""
    poses = np.asarray(poses, np.float32)
    d = poses.shape[-1] - 1
    cand = _candidates(poses, min_index_gap, max_dist)
    empty = ([], [], np.zeros((0, d + 1, d + 1), np.float32), [])
    if not cand:
        return empty
    ii = np.array([c[0] for c in cand], np.int64)
    jj = np.array([c[1] for c in cand], np.int64)
    rel0 = np.stack([np.linalg.inv(poses[i]) @ poses[j] for i, j in cand])

    refs = np.unique(ii)
    normals = torch.zeros_like(kf_pos)
    ref_t = torch.as_tensor(refs).to(kf_pos.device)
    normals[ref_t] = keyframe_normals(kf_pos[ref_t], kf_mask[ref_t],
                                      radius=normal_radius)
    ii_t = torch.as_tensor(ii).to(kf_pos.device)
    jj_t = torch.as_tensor(jj).to(kf_pos.device)
    T, overlap, rms = register_pairs_batched(
        kf_pos[jj_t], kf_mask[jj_t], kf_pos[ii_t], normals[ii_t],
        kf_mask[ii_t], rel0, max_dist=match_max_dist, iters=iters)
    T = T.cpu().numpy()
    overlap = overlap.cpu().numpy()
    rms = rms.cpu().numpy()

    keep = (overlap >= min_overlap) & (rms <= max_rms)
    if not keep.any():
        return empty
    return ([int(v) for v in ii[keep]], [int(v) for v in jj[keep]],
            T[keep].astype(np.float32), [float(v) for v in overlap[keep]])


def detect_loop_closures(
    keyframe_scans, poses: np.ndarray, icp_engine,
    min_index_gap: int = 10, max_dist: float = 5.0,
    min_overlap: float = 0.5, device="cuda",
):
    """Candidate loop closures: keyframe pairs spatially close but far in
    time; each candidate is verified by re-registering the scans with the
    given ICP engine, one pair after another.  Scans given as arrays are
    put on ``device``.  Returns (ei, ej, Z, weights)."""
    from ..points import PointBatch
    dev = resolve_device(device)
    poses = np.asarray(poses, np.float32)
    d = poses.shape[-1] - 1

    def batch(s):
        return (s if isinstance(s, PointBatch)
                else PointBatch.from_numpy(np.asarray(s, np.float32),
                                           device=dev))

    ei, ej, Z, w = [], [], [], []
    for i, j in _candidates(poses, min_index_gap, max_dist):
        icp_engine.set_map(batch(keyframe_scans[i]))
        # initial guess: the current relative pose; the reading expressed in
        # frame i via that guess, ICP refines the residual error
        rel0 = (np.linalg.inv(poses[i]) @ poses[j]).astype(np.float32)
        moved = se3.apply(torch.from_numpy(rel0), batch(keyframe_scans[j]))
        result = icp_engine(moved)
        if float(result.overlap) < min_overlap:
            continue
        ei.append(i)
        ej.append(j)
        Z.append((result.correction.numpy() @ rel0).astype(np.float32))
        w.append(float(result.overlap))
    if not Z:
        return [], [], np.zeros((0, d + 1, d + 1), np.float32), []
    return ei, ej, np.stack(Z), w
