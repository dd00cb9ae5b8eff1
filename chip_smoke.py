#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Drives the port's offline mapping path at real size and holds every
hand-written CUDA kernel against its plain PyTorch version on the card.
Needs a CUDA device and ``nvcc`` (the kernels are compiled from
``norlab_icp_mapper_tpu_torch/csrc`` at first use); exits non-zero without
them, or when any check fails.  Every result is one JSON object per line on
standard output; the last line is the verdict
``{"ok": true, "device": {...}}`` and is printed only if every phase passed.

Phases:
  card      the card's name and power limit, torch and CUDA versions
  build     compiles the kernels (all sources in parallel), prints the seconds
  kernels   each kernel against its plain version at the path's shapes
  identity  a Mapper on examples/config.yaml fed a synthetic lidar sequence
  p2plane   a Mapper on examples/config_p2plane.yaml, pose priors perturbed

The sequence is 18 scans of a ray-cast lidar (64 rings x 768 azimuths =
49,152 rays) in an analytic hall of 60 x 25 x 5 m with box obstacles, made
with numpy from ``--seed``.  The hall is dense enough that most search
windows reach their cap ``W`` (the stress case); the kernels phase also
holds every kernel shape against its plain version on a sparser seeded
cloud of the same capacities where no window overflows, which is where the
search is exact.

In the ``kernels`` line, ``replaces`` gives file:line inside the JAX
reference package that stands beside the port.

Bounds use the published peaks of one H100 SXM: 67 TFLOP/s float32 outside
the tensor cores and 3.35 TB/s of device memory.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_F32_FLOPS = 67.0e12
PEAK_BYTES = 3.35e12
HERE = os.path.dirname(os.path.abspath(__file__))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


# ---------------------------------------------------------------------------
# synthetic world: a ray-cast lidar in a hall with box obstacles
# ---------------------------------------------------------------------------

HALL = np.array([[0.0, 60.0], [0.0, 25.0], [0.0, 5.0]])
BOXES = np.array([  # [xmin, xmax, ymin, ymax, zmin, zmax]
    [12.0, 14.0, 4.0, 7.0, 0.0, 2.5],
    [22.0, 25.0, 16.0, 19.0, 0.0, 3.0],
    [30.0, 31.5, 8.0, 12.0, 0.0, 2.0],
    [38.0, 41.0, 3.0, 5.0, 0.0, 1.5],
    [46.0, 48.0, 15.0, 21.0, 0.0, 3.5],
    [8.0, 9.0, 17.0, 18.0, 0.0, 4.0],
])
N_RINGS = 64
N_SCANS = 18
SCAN_CAPACITY = 49_152
MAP_CAPACITY = 131_072
SENSOR_HEIGHT = 1.2
WORLD_YAW = np.deg2rad(30.0)  # walls are not aligned with the sweep axis


def rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4)
    T[:2, :2] = [[c, -s], [s, c]]
    return T


def lidar_dirs() -> np.ndarray:
    n_az = SCAN_CAPACITY // N_RINGS
    el = np.deg2rad(np.linspace(-25.0, 15.0, N_RINGS))
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    el_g, az_g = np.meshgrid(el, az, indexing="ij")
    d = np.stack([np.cos(el_g) * np.cos(az_g), np.cos(el_g) * np.sin(az_g),
                  np.sin(el_g)], axis=-1)
    return d.reshape(-1, 3)


def ray_cast(origin: np.ndarray, dirs: np.ndarray) -> np.ndarray:
    """Range of the first hit of each ray (hall walls from inside, boxes
    from outside); the hall is closed, so every ray hits."""
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = 1.0 / dirs
        # inside the hall: exit distance of the slab intersection
        t1 = (HALL[:, 0] - origin) * inv
        t2 = (HALL[:, 1] - origin) * inv
        t_hit = np.min(np.maximum(t1, t2), axis=1)
        for b in BOXES:
            lo, hi = b[0::2], b[1::2]
            a1 = (lo - origin) * inv
            a2 = (hi - origin) * inv
            t_near = np.max(np.minimum(a1, a2), axis=1)
            t_far = np.min(np.maximum(a1, a2), axis=1)
            hit = (t_near <= t_far) & (t_near > 0)
            t_hit = np.where(hit & (t_near < t_hit), t_near, t_hit)
    return t_hit


def make_sequence(seed: int, n_scans: int):
    """Scans in the sensor frame (float32 [49152, 3]) and true poses (4x4,
    world frame = hall frame turned by WORLD_YAW)."""
    rng = np.random.default_rng(seed)
    dirs = lidar_dirs()
    G = rot_z(WORLD_YAW)
    scans, poses = [], []
    for i in range(n_scans):
        x = 6.0 + 0.8 * i
        y = 12.0 + 1.5 * np.sin(0.35 * i)
        yaw = 0.08 * np.sin(0.5 * i)
        P = rot_z(yaw)
        P[:3, 3] = [x, y, SENSOR_HEIGHT]
        d_hall = dirs @ P[:3, :3].T
        rng_m = ray_cast(P[:3, 3], d_hall)
        rng_m = rng_m + rng.normal(scale=0.01, size=rng_m.shape)
        scans.append((dirs * rng_m[:, None]).astype(np.float32))
        poses.append((G @ P).astype(np.float32))
    return scans, poses


def perturb(pose: np.ndarray, rng, sigma_t=0.0866, sigma_r=np.deg2rad(0.58)):
    """Left-multiply seeded SE(3) noise: translation ~0.15 m and rotation
    ~1 degree in norm (per-axis sigma = norm / sqrt(3))."""
    w = rng.normal(scale=sigma_r, size=3)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    R = np.eye(3) + (np.sin(th) / th) * K + ((1 - np.cos(th)) / th**2) * K @ K
    out = pose.astype(np.float64).copy()
    out[:3, :3] = R @ out[:3, :3]
    out[:3, 3] = out[:3, 3] + rng.normal(scale=sigma_t, size=3)
    return out.astype(np.float32)


def ate(est, true) -> float:
    d = np.stack([e[:3, 3] - t[:3, 3] for e, t in zip(est, true)])
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))


# ---------------------------------------------------------------------------
# timing helpers
# ---------------------------------------------------------------------------

def time_cuda(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` between CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    emit({"phase": "card", "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})
    return card


def phase_build():
    from norlab_icp_mapper_tpu_torch.ops import _build
    t0 = time.time()
    _build.start_builds()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    secs = time.time() - t0
    regs = {}
    for name, log in _build.build_logs.items():
        regs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln][:24]
    emit({"phase": "build", "seconds": round(secs, 2),
          "sources": [f"norlab_icp_mapper_tpu_torch/csrc/{n}.cu"
                      for n in _build.KERNEL_SOURCES], "ptxas": regs})


def _sorted_padded(q, qm, q_tile):
    """Sorted queries as the wrapper hands them to the kernel: padded to a
    whole number of tiles, with their sweep coordinate."""
    from norlab_icp_mapper_tpu_torch.ops import nn_sweep as S
    qx = torch.where(qm, q[:, 0], torch.full_like(q[:, 0], S.BIG))
    n = q.shape[0]
    pad = -(-n // q_tile) * q_tile - n
    return (S.pad_rows(q, pad, S.BIG).contiguous(),
            S.pad_rows(qm, pad, False).contiguous(), S.pad_rows(qx, pad, S.BIG))


def sweep_case(name, query, qmask, ref, rmask, k, radius, q_tile, W,
               replaces_line, exact=False):
    """One sweep_knn shape: wrapper against plain wrapper, then the kernel
    launch alone against the plain search alone, timed.  ``exact`` demands
    that no window overflows, so the result is the true radius k-NN."""
    from norlab_icp_mapper_tpu_torch.ops import nn_sweep as S
    dim = query.shape[1]
    pack = S.presort_ref(ref, rmask)
    # the engine sorts its reading once and searches with assume_sorted
    qx = torch.where(qmask, query[:, 0], torch.full_like(query[:, 0], 1e9))
    order = torch.sort(qx, stable=True).indices
    q_srt, qm_srt = query[order].contiguous(), qmask[order].contiguous()
    kw = dict(k=k, max_radius=radius, q_tile=q_tile, W=W, presorted=pack,
              assume_sorted=True)
    d_k, i_k, ov = S.sweep_knn(q_srt, ref, qm_srt, rmask, **kw)
    torch.cuda.synchronize()
    t0 = time.time()
    d_p, i_p, ov_p = S.sweep_knn_plain(q_srt, ref, qm_srt, rmask, **kw)
    torch.cuda.synchronize()
    plain_wrapper_ms = (time.time() - t0) * 1e3

    check(int(ov) == int(ov_p), f"{name}: overflow differs from the plain "
                                "version's")
    if exact:
        check(int(ov) == 0, f"{name}: {int(ov)} tiles overflow on the cloud "
                            "made for the exact case")
    r2 = float(np.float32(radius) * np.float32(radius))
    fin = torch.isfinite(d_p)
    check(bool((torch.isfinite(d_k) == fin).all()),
          f"{name}: validity pattern differs from the plain version")
    max_err = float((d_k[fin] - d_p[fin]).abs().max()) if fin.any() else 0.0
    tol = 1e-6 * r2
    check(max_err <= tol, f"{name}: max |d2 - plain| = {max_err} > {tol}")
    # every returned index really is the point at the returned distance:
    # d2 recomputed from ref[index], in the centred frame and operation
    # order of the search, must equal the returned d2 (this fails a
    # neighbouring or shifted index unless it is an exact tie), and lies
    # within the radius
    hit = i_k >= 0
    check(bool((hit == fin).all()),
          f"{name}: an index is -1 where a distance is finite, or the reverse")
    qq = (q_srt - pack.center)[:, None, :].expand(-1, k, -1)[hit]
    rr = (ref - pack.center)[i_k[hit]]
    d_idx = (rr[:, 0] - qq[:, 0]) ** 2
    for a in range(1, dim):
        d_idx = d_idx + (rr[:, a] - qq[:, a]) ** 2
    idx_err = float((d_idx - d_k[hit]).abs().max()) if hit.any() else 0.0
    check(idx_err <= tol, f"{name}: d2 recomputed from the returned indices "
                          f"differs from the returned d2 by {idx_err} > {tol}")
    check(bool((d_idx <= r2).all()),
          f"{name}: a returned neighbour lies outside the radius")
    check(bool(rmask[i_k[hit]].all()),
          f"{name}: a returned neighbour is an invalid reference")
    # indices equal the plain version's, except where two references tie
    same = i_k == i_p
    frac_same = float(same.float().mean())
    differ = ~same & fin
    tie_err = float((d_k[differ] - d_p[differ]).abs().max()) \
        if differ.any() else 0.0
    check(tie_err == 0.0, f"{name}: indices differ from the plain version's "
                          f"where the distances do not tie ({tie_err})")

    # kernel launch alone vs plain search alone, on the same windows
    qc = q_srt - pack.center
    q_s, qm_s, qx_s = _sorted_padded(qc, qm_srt, q_tile)
    r_t = torch.tensor(float(np.float32(radius)), device=query.device)
    Wc = min(W, ref.shape[0])
    t_start, t_end, live, overflow, b_start, b_end = S.sweep_windows(
        qx_s, qm_s, pack, r_t, q_tile, Wc, S._KERNEL_BLOCK)
    n_pad = q_s.shape[0]
    before = (S.sweep_knn.launches, dict(S.sweep_knn.launches_by_shape))
    ms = time_cuda(lambda: S._search_kernel(q_s, qm_s, pack.ref_s, b_start,
                                            b_end, r2, k, n_pad))
    wrapper_ms = time_cuda(lambda: S.sweep_knn(q_srt, ref, qm_srt, rmask, **kw))
    torch.cuda.synchronize()
    t0 = time.time()
    S._search_plain(q_s, qm_s, pack.ref_s, t_start, t_end, live, r2, k, q_tile)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3

    # the bound, from this run's windows
    spans = (b_end - b_start)
    valid_per_block = qm_s.view(-1, S._KERNEL_BLOCK).sum(1)
    pairs = int((spans * valid_per_block).sum())
    flops_pair = 3 * dim  # D subtractions, D products, D-1 sums, 1 compare
    n_valid_ref = int(pack.n_valid)
    n = query.shape[0]
    bytes_moved = (n * dim * 4 + n + n_valid_ref * dim * 4
                   + 2 * 4 * spans.shape[0] + n * k * 8)
    ops_ms = pairs * flops_pair / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    live_spans = spans[valid_per_block > 0].float()
    t_spans = (t_end - t_start)[live].float()
    res = {
        "phase": "kernel_case", "case": name, "D": dim, "k": k,
        "N": n, "M": ref.shape[0], "valid_queries": int(qmask.sum()),
        "valid_refs": n_valid_ref, "radius": radius, "q_tile": q_tile,
        "W": W, "overflow": int(ov), "overflow_plain": int(ov_p),
        "max_abs_err_d2": max_err, "tolerance_d2": tol,
        "max_abs_err_d2_from_idx": idx_err,
        "frac_idx_equal": frac_same, "kernel_ms": ms,
        "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "plain_wrapper_ms": plain_wrapper_ms, "pairs": pairs,
        "gpairs_per_s": pairs / (ms * 1e-3) / 1e9,
        "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
        "block_span_min_med_max": [float(live_spans.min()),
                                   float(live_spans.median()),
                                   float(live_spans.max())],
        "tile_span_min_med_max": [float(t_spans.min()),
                                  float(t_spans.median()),
                                  float(t_spans.max())],
    }
    emit(res)
    S.sweep_knn.launches, S.sweep_knn.launches_by_shape = before
    return {
        "name": f"sweep_knn[D={dim},k={k}]", "route": "cuda",
        "source": "norlab_icp_mapper_tpu_torch/csrc/sweep_knn.cu",
        "replaces": f"ops/nn_sweep.py:{replaces_line}",
        "launches": 0, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def pca_case(name, pts, mask, radius, q_tile, W, on_path: bool,
             exact=False):
    from norlab_icp_mapper_tpu_torch.ops import nn_sweep as S
    from norlab_icp_mapper_tpu_torch.ops import pca as P
    dim = pts.shape[1]
    cnt_k, mean_k, cov_k, ov = P.radius_pca(pts, pts, mask, mask,
                                            max_radius=radius, q_tile=q_tile,
                                            W=W)
    torch.cuda.synchronize()
    cnt_p, mean_p, cov_p, ov_p = P.radius_pca_plain(
        pts, pts, mask, mask, max_radius=radius, q_tile=q_tile, W=W)
    torch.cuda.synchronize()
    check(int(ov) == int(ov_p), f"{name}: overflow differs from the plain "
                                "version's")
    if exact:
        check(int(ov) == 0, f"{name}: {int(ov)} tiles overflow on the cloud "
                            "made for the exact case")
    count_flips = int((cnt_k != cnt_p).sum())
    check(count_flips == 0,
          f"{name}: {count_flips} neighbour counts differ from the plain "
          "version (the distance gate is meant to agree bit for bit)")

    # kernel alone vs plain moments alone on the same windows
    c = torch.where(mask[:, None], pts, torch.zeros_like(pts)).sum(0) \
        / mask.sum().clamp(min=1)
    pc = pts - c
    ref_x = torch.where(mask, pc[:, 0], torch.full_like(pc[:, 0], S.BIG))
    order = torch.sort(ref_x, stable=True).indices
    ref_s = pc[order].contiguous()
    pack = S.RefPack(ref_s, mask[order], ref_x[order].contiguous(), order,
                     mask.sum(), torch.zeros(dim, device=pts.device))
    q_s, qm_s, qx_s = _sorted_padded(ref_s, mask[order], q_tile)
    r_t = torch.tensor(float(radius), device=pts.device)
    r2 = float(np.float32(radius * radius))
    Wc = min(W, pts.shape[0])
    t_start, t_end, live, overflow, b_start, b_end = S.sweep_windows(
        qx_s, qm_s, pack, r_t, q_tile, Wc, S._KERNEL_BLOCK)
    n_pad = q_s.shape[0]
    before = P.radius_pca.launches
    acc_k = P._moments_kernel(q_s, qm_s, ref_s, b_start, b_end, r2, n_pad)
    acc_p = P._moments_plain(q_s, qm_s, ref_s, t_start, t_end, live, r2,
                             q_tile)
    torch.cuda.synchronize()
    # sums are taken in another order than the plain matrix product:
    # tolerance 1e-5 of each moment row's largest magnitude
    scale = acc_p.abs().amax(1).clamp(min=1.0)
    rel = ((acc_k - acc_p).abs().amax(1) / scale)
    max_rel = float(rel.max())
    max_abs = float((acc_k - acc_p).abs().max())
    check(max_rel <= 1e-5, f"{name}: moment rows differ by {max_rel} of "
                           "their magnitude (> 1e-5)")
    ms = time_cuda(lambda: P._moments_kernel(q_s, qm_s, ref_s, b_start,
                                             b_end, r2, n_pad))
    wrapper_ms = time_cuda(lambda: P.radius_pca(
        pts, pts, mask, mask, max_radius=radius, q_tile=q_tile, W=W))
    torch.cuda.synchronize()
    t0 = time.time()
    P._moments_plain(q_s, qm_s, ref_s, t_start, t_end, live, r2, q_tile)
    torch.cuda.synchronize()
    plain_ms = (time.time() - t0) * 1e3
    P.radius_pca.launches = before

    spans = (b_end - b_start)
    valid_per_block = qm_s.view(-1, S._KERNEL_BLOCK).sum(1)
    pairs = int((spans * valid_per_block).sum())
    hits = int(cnt_k.sum())
    nm = P._n_moments(dim)
    # per pair the distance test; per hit 1 + D adds and D + D(D-1)/2 FMAs
    flops = pairs * 3 * dim + hits * (1 + dim + 2 * dim + dim * (dim - 1))
    n = pts.shape[0]
    n_valid = int(mask.sum())
    bytes_moved = (n * dim * 4 + n + n_valid * dim * 4
                   + 2 * 4 * spans.shape[0] + n * nm * 4)
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    live_spans = spans[valid_per_block > 0].float()
    emit({
        "phase": "kernel_case", "case": name, "D": dim, "N": n,
        "valid": n_valid, "radius": radius, "q_tile": q_tile, "W": W,
        "overflow": int(ov), "overflow_plain": int(ov_p),
        "count_flips": count_flips, "max_abs_err_moments": max_abs,
        "max_rel_err_moments": max_rel, "tolerance_rel": 1e-5,
        "max_abs_err_cov": float((cov_k - cov_p).abs().max()),
        "mean_neighbours": hits / max(n_valid, 1),
        "kernel_ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
        "pairs": pairs, "hits": hits,
        "gpairs_per_s": pairs / (ms * 1e-3) / 1e9,
        "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
        "block_span_min_med_max": [float(live_spans.min()),
                                   float(live_spans.median()),
                                   float(live_spans.max())],
    })
    if not on_path:
        return None
    return {
        "name": f"radius_pca[D={dim}]", "route": "cuda",
        "source": "norlab_icp_mapper_tpu_torch/csrc/radius_pca.cu",
        "replaces": "ops/pca.py:136",
        "launches": 0, "max_abs_err": max_abs, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def numpy_map(scans, poses, voxel=0.15):
    """A map-like cloud without the Mapper: the union of the scans in the
    world frame, one point per voxel (numpy)."""
    pts = np.concatenate([s @ p[:3, :3].T + p[:3, 3]
                          for s, p in zip(scans, poses)])
    keys = np.floor(pts / voxel).astype(np.int64)
    _, first = np.unique(keys, axis=0, return_index=True)
    return pts[np.sort(first)].astype(np.float32)


def phase_kernels(scans, poses, seed):
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch.mapper_modules.core import \
        _spherical_angles
    dev = torch.device("cuda")
    # map: capacity 131,072; scan: capacity 49,152, in the map frame
    world_pts = numpy_map(scans[:8], poses[:8])
    rng = np.random.default_rng(seed)
    if world_pts.shape[0] > 110_000:
        world_pts = world_pts[np.sort(rng.choice(world_pts.shape[0], 110_000,
                                                 replace=False))]
    mp = nt.PointBatch.from_numpy(world_pts, capacity=MAP_CAPACITY,
                                  device=dev)
    sc = nt.PointBatch.from_numpy(scans[8], capacity=SCAN_CAPACITY,
                                  device=dev)
    scan_m = nt.se3.apply(torch.from_numpy(poses[8]), sc)
    # a few invalid scan points, as the input filters leave them
    drop = torch.from_numpy(rng.random(SCAN_CAPACITY) < 0.1).to(dev)
    smask = scan_m.mask & ~drop

    entries = []
    entries.append(sweep_case("icp_matcher_k1", scan_m.positions, smask,
                              mp.positions, mp.mask, 1, 2.0, 1024, 8192, 112))
    entries.append(sweep_case("icp_matcher_k3", scan_m.positions, smask,
                              mp.positions, mp.mask, 3, 2.0, 1024, 8192, 112))
    # angular 1-NN of DynamicPoints: map beams against scan beams
    inv = nt.se3.inverse(torch.from_numpy(poses[8]))
    map_s = nt.se3.apply_points(inv, mp.positions)
    map_ang = _spherical_angles(map_s, torch.linalg.norm(map_s, dim=1))
    scan_ang = _spherical_angles(sc.positions,
                                 torch.linalg.norm(sc.positions, dim=1))
    entries.append(sweep_case("dynamic_points_angular", map_ang, mp.mask,
                              scan_ang, sc.mask & ~drop, 1, 0.02, 1024, 1024,
                              112))
    entries.append(pca_case("surface_normals_self", mp.positions, mp.mask,
                            1.0, 1024, 2048, on_path=True))
    p2 = torch.from_numpy(
        rng.uniform(-20, 20, size=(4096, 2)).astype(np.float32)).to(dev)
    m2 = torch.from_numpy(rng.random(4096) > 0.1).to(dev)
    pca_case("small_2d", p2, m2, 1.0, 1024, 2048, on_path=False)
    exact_cases(rng, dev)
    return entries


def exact_cases(rng, dev):
    """The same four shapes on a cloud sparse enough along the sweep axis
    that no window reaches ``W``: there the search is exact, and kernel and
    plain version are both the true radius search.  A seeded uniform cloud in
    a box of 400 x 40 x 4 m (about 275 map points per metre of x, against
    about 2,700 in the hall), at the path's capacities."""
    import norlab_icp_mapper_tpu_torch as nt
    n_map, n_scan = 110_000, 44_000
    box = np.array([400.0, 40.0, 4.0])
    pts = (rng.random((n_map, 3)) * box).astype(np.float32)
    mp = nt.PointBatch.from_numpy(pts, capacity=MAP_CAPACITY, device=dev)
    # the reading: a subset of the map moved by 5 cm of noise
    pick = rng.choice(n_map, n_scan, replace=False)
    rd = pts[pick] + rng.normal(scale=0.05, size=(n_scan, 3)).astype(
        np.float32)
    sc = nt.PointBatch.from_numpy(rd, capacity=SCAN_CAPACITY, device=dev)
    for k in (1, 3):
        sweep_case(f"exact_icp_matcher_k{k}", sc.positions, sc.mask,
                   mp.positions, mp.mask, k, 2.0, 1024, 8192, 112, exact=True)
    # beams spread evenly over the lidar's field of view
    lo, hi = np.array([-np.pi, -0.44]), np.array([np.pi, 0.26])
    beams_map = (lo + rng.random((n_map, 2)) * (hi - lo)).astype(np.float32)
    beams_scan = (lo + rng.random((n_scan, 2)) * (hi - lo)).astype(np.float32)
    bm = nt.PointBatch.from_numpy(beams_map, capacity=MAP_CAPACITY,
                                  device=dev)
    bs = nt.PointBatch.from_numpy(beams_scan, capacity=SCAN_CAPACITY,
                                  device=dev)
    sweep_case("exact_dynamic_points_angular", bm.positions, bm.mask,
               bs.positions, bs.mask, 1, 0.02, 1024, 1024, 112, exact=True)
    pca_case("exact_surface_normals_self", mp.positions, mp.mask, 1.0, 1024,
             2048, on_path=False, exact=True)


def reset_counts():
    from norlab_icp_mapper_tpu_torch.ops.nn_sweep import sweep_knn
    from norlab_icp_mapper_tpu_torch.ops.pca import radius_pca
    sweep_knn.launches = 0
    sweep_knn.launches_by_shape = {}
    radius_pca.launches = 0


def read_counts():
    from norlab_icp_mapper_tpu_torch.ops.nn_sweep import sweep_knn
    from norlab_icp_mapper_tpu_torch.ops.pca import radius_pca
    out = {f"sweep_knn[D={d},k={k}]": v
           for (d, k), v in sweep_knn.launches_by_shape.items()}
    out["radius_pca[D=3]"] = radius_pca.launches
    out["sweep_knn"] = sweep_knn.launches
    return out


def drive(config_name, scans, priors, phase):
    """Feed the sequence through a fresh Mapper; returns per-scan records."""
    import norlab_icp_mapper_tpu_torch as nt
    mapper = nt.Mapper(os.path.join(HERE, "examples", config_name),
                       is_3d=True, device="cuda", seed=0)
    mapper.timer.enabled = True
    reset_counts()
    per_scan, counts, valid, iters = [], [], [], []
    for i, (scan, prior) in enumerate(zip(scans, priors)):
        mapper.drain()
        t0 = time.time()
        batch = nt.PointBatch.from_numpy(scan, capacity=SCAN_CAPACITY,
                                         device="cuda")
        filtered = mapper.apply_input_filters(batch)
        mapper.process_input(filtered, prior, int(i * 1e8))
        mapper.drain()
        per_scan.append((time.time() - t0) * 1e3)
        counts.append(mapper.map.known_count())
        valid.append(int(filtered.count()))
        iters.append(int(mapper.last_iterations))
        if i == 1:
            # the first two scans carry one-time set-up (the bootstrap
            # scan, library handles): their phase times are kept apart
            warmup = mapper.timer.totals()
    launches = read_counts()
    phases = mapper.timer.totals()
    overflow = {
        "icp_matcher": int(mapper.icp.last_overflow or 0),
        "dynamic_points": int(mapper.map.modules[0].last_overflow or 0),
        "surface_normals": int(mapper.post_filters.filters[0].last_overflow
                               or 0),
    }
    steady = per_scan[2:]
    rec = {
        "phase": phase, "config": f"examples/{config_name}",
        "scans": len(scans), "valid_points_per_scan_min": min(valid),
        "per_scan_ms": [round(v, 2) for v in per_scan],
        "steady_ms_per_scan": statistics.mean(steady),
        "scans_per_s": 1e3 / statistics.mean(steady),
        "map_counts": counts, "final_map_count": counts[-1],
        "map_capacity": mapper.map.local.capacity,
        "icp_iterations": iters, "launches": launches,
        "phase_ms_steady_total": {k: round(v, 2) for k, v in phases.items()},
        "phase_ms_first_two_scans": {k: round(v, 2)
                                     for k, v in warmup.items()},
        "last_scan_overflow_tiles": overflow,
    }
    return mapper, rec


def check_map(mapper, rec, n_scans):
    m = mapper.get_map()
    n = m["positions"].shape[0]
    check(n >= 80_000, f"final map holds {n} points (< 80,000)")
    check(np.isfinite(m["positions"]).all(), "non-finite map positions")
    nrm = np.linalg.norm(m["normals"], axis=1)
    check(np.abs(nrm - 1.0).max() < 1e-3, "a map normal is not unit length")
    pd = m["probabilityDynamic"]
    check(((pd >= 0) & (pd <= 1)).all(), "probabilityDynamic outside [0, 1]")
    check(len(mapper.get_trajectory()) == n_scans,
          "trajectory length differs from the number of scans")
    check(rec["valid_points_per_scan_min"] >= 40_000,
          "fewer than 40,000 valid points in a scan after the input filters")
    # the map may lose dynamic-point cuts, never a large share at once
    c = rec["map_counts"]
    check(all(b >= 0.9 * a for a, b in zip(c, c[1:])),
          f"map count dropped by more than 10 % in one scan: {c}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import norlab_icp_mapper_tpu_torch  # noqa: F401  (fails outside the repo)

    card = phase_card()
    phase_build()
    t0 = time.time()
    scans, poses = make_sequence(args.seed, N_SCANS)
    emit({"phase": "sequence", "seconds": round(time.time() - t0, 2),
          "scans": len(scans), "rays_per_scan": scans[0].shape[0]})
    entries = phase_kernels(scans, poses, args.seed)

    # ---- identity: trusted odometry
    mapper, rec = drive("config.yaml", scans, poses, "identity")
    emit(rec)
    check_map(mapper, rec, len(scans))
    id_launch = rec["launches"]
    check(id_launch.get("sweep_knn[D=3,k=1]", 0) > 0
          and id_launch.get("sweep_knn[D=2,k=1]", 0) > 0
          and id_launch["radius_pca[D=3]"] > 0,
          f"identity: a kernel of the path was never launched: {id_launch}")

    # ---- p2plane: perturbed priors, the first pose anchors the map
    rng = np.random.default_rng(args.seed + 1)
    priors = [poses[0]] + [perturb(p, rng) for p in poses[1:]]
    mapper, rec = drive("config_p2plane.yaml", scans, priors, "p2plane")
    est = mapper.get_trajectory().poses
    prior_ate = ate(priors[1:], poses[1:])
    rec_ate = ate(est[1:], poses[1:])
    its = rec["icp_iterations"][1:]
    rec.update({
        "prior_ate_m": prior_ate, "recovered_ate_m": rec_ate,
        "mean_icp_iterations": statistics.mean(its),
        # over the steady-state scans, as scans/s is
        "ms_per_gn_iteration": (rec["phase_ms_steady_total"]["solve"]
                                / sum(its[1:])),
    })
    p2_launch = rec["launches"]
    emit(rec)
    check_map(mapper, rec, len(scans))
    check(rec_ate < prior_ate / 3.0,
          f"p2plane: recovered ATE {rec_ate} not below a third of the "
          f"prior's {prior_ate}")
    check(statistics.mean(its) > 1.0, "p2plane: the solver did not iterate")
    check(p2_launch.get("sweep_knn[D=3,k=3]", 0) > 0
          and p2_launch.get("sweep_knn[D=2,k=1]", 0) > 0
          and p2_launch["radius_pca[D=3]"] > 0,
          f"p2plane: a kernel of the path was never launched: {p2_launch}")

    # ---- the kernels line: launches are the main path's (both configs)
    for e in entries:
        e["launches"] = (id_launch.get(e["name"], 0)
                         + p2_launch.get(e["name"], 0))
        e["launches_identity"] = id_launch.get(e["name"], 0)
        e["launches_p2plane"] = p2_launch.get(e["name"], 0)
        check(e["launches"] > 0, f"{e['name']} was never launched")
    print(card, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
