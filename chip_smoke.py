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
  kernels   each kernel against its plain version at the path's shapes, and
            the WHILE node that runs the ICP loop (a body of one
            ``loop_commit`` that sets its condition) against a Python loop;
            ``loop_commit`` (active and inactive, the differential checker
            warming, tripping and holding, the bound checker, the identity
            minimizer, 2-D and 3-D; bit for bit), ``kabsch`` (well
            conditioned, reflection, rank 2, near identity, 2-D; bit for
            bit, and against a float64 SVD), ``p2p_step`` (49,152 rows at
            k = 1 and 3, 2-D: float64 moments within 1e-12, the solve bit
            for bit on the same moments, dT within 1e-6, R against a float64
            SVD), ``philox`` (49,152 rows and ragged lengths, bit for
            bit) and ``philox_keep`` (the keep bit of a RandomSampling
            step filter on original rows: 49,152 rows and ragged lengths,
            rows a permutation and none, prob 0.9, 0 and 1, a mask with
            holes; bit for bit)
  identity  a Mapper on examples/config.yaml fed a synthetic lidar sequence,
            drained after every scan; the steady-state scans' filters and
            step run under ``torch.cuda.set_sync_debug_mode("error")``
            (``sync_check``); then the same sequence free-running (no drain
            between scans): ``free_running_scans_per_s``
  p2plane   a Mapper on examples/config_p2plane.yaml, pose priors perturbed,
            as identity; then the last scan's solve replayed from its CUDA
            graph against the same body under the Python loop
            (``p2plane_graph_vs_loop``: T bit for bit)
  online    the p2plane config with ``is_online=True``, free-running, with
            ``get_pose()`` timed after every scan; trajectory and map held
            against the offline free-running run
  default   a Mapper without a config (``Mapper(None)``: matcher without
            maxDist, k-NN normals, PointDistanceMapperModule), same priors,
            with its own ``default_graph_vs_loop``
  p2point   the default config with the point-to-point minimizer, median and
            surface-normal outlier filters and a step filter, 6 scans; then
            4 scans with a bound checker added (the stepwise path); every
            solve a graph replay (Kabsch and the step draws on the card),
            the steady solves without a synchronising call, the last one
            against its Python loop bit for bit
  p2plane_step  the p2plane config with a random step filter (prob 0.9),
            18 scans, steady scans under ``"error"``: graph against loop
            bit for bit, the last solve on the card against the CPU's with
            the same keyed draws (1e-4), its first pass's step mask (the
            sorted reading, ``rows`` = the sort) against the permute path
            bit for bit, ATE below a third of the prior's; then
            ``p2plane_step_octree``, a random octree decimation in front of
            the random step filter (the permute path, ``philox`` drawing
            its priorities): graph against loop bit for bit, ATE
  tracing   the p2plane config again with the overflow sink installed
            (``utils.tracing``): steady scans without a blocking read, and
            ``overflow_totals()`` equal to the sum of the counts the passes
            returned; the last SurfaceNormal pass's recorded count equal to
            its plain version's, and an insert planted past capacity
            recording the points it drops
  checkpoint  the p2plane mapper saved (``utils.save_checkpoint``), loaded
            into a fresh Mapper with ``localization_only=True``, the last
            scan registered again: its pose within 1 mm and 0.1 degree
  octree_k  examples/config.yaml with ``maxPointByNode: 4`` (set in memory)
            over the sequence, strict: 0 blocking reads, a smaller map than
            identity's; then ``_octree_select`` on the card against the CPU
            on the full union (131,072 + 49,152 rows), four methods, bit
            for bit
  filters   the ten filters of the zoo on a 49,152-point scan, card against
            CPU; then a config whose input chain adds RemoveNaN, MinDist,
            MaxDist, VoxelGrid and ObservationDirection, strict
  posegraph a closed loop of 36 scans 0.8 m apart around a box, drifting
            odometry, ``enable_keyframes(min_distance=1.0)`` and
            ``refine_trajectory(max_dist=3.0)``, the first call's set-up
            split by the calls it makes: a loop closure, none false, less
            keyframe error than the drift, keyframe normals without
            overflow, registrations with the kernels against their plain
            version; then ``refine_trajectory()`` at its defaults (pairs
            within 8 m): less keyframe error than the drift, its false
            closures counted against the truth;
            ``knn_brute`` and ``radius_pca`` held at this path's shapes
  cli       the sequence written to files (VTK, and one PLY, one binary PCD,
            one CSV; ``icp_odom.csv``) and built into a map by
            ``build_map.main`` on the card (examples/config.yaml): steady
            scans under ``"error"``, the loader's threads included; the
            written map and trajectory bit for bit those of a Mapper fed in
            memory with the decoded arrays; CLI scans/s beside the
            in-memory free-running scans/s, parse ms per format
  distributed  ``DistributedICP`` on a one-rank NCCL group
            (``multihost.initialize``, ``make_mesh``): identity's map with
            its normals, one scan moved by a known 6-DoF error; the error
            undone, the single-device engine's result within 1e-4, the
            CPU's (gloo) within 1e-5, no blocking read, ``knn_brute`` at
            this shape against its plain version; the groups destroyed
  sharded   the sharded per-scan mapper, ``Mapper(config, mesh=...)``: one
            rank over NCCL (the p2plane config with the p2plane priors,
            steady scans under ``"error"``, then free-running, beside the
            masked Python loop's numbers; the solve's graph -- all 40 masked iterations with
            their NCCL reductions, no WHILE node -- against the same
            iterations run eagerly, bit for bit; with a
            PointDistanceMapperModule for the insert gate; point-to-point
            without a counted read; with the
            matcher unbounded for the brute-force 1-NN; the identity
            config): ATE and map size against the single-device port's;
            the kernels at the sharded shapes (the matcher, the insert
            gate and the angular 1-NN on a rank's block, the halo PCA of
            rank 0 of two with its ghosts, the unbounded matcher) against
            their plain versions; two gloo ranks in two processes on the
            one card (gloo's collectives on CUDA tensors probed first):
            the identity map equal to one rank's voxel for voxel, both
            ranks' replicated state bit for bit, collective time per ICP
            iteration and halo bytes per merge; device launches per
            steady scan beside the single-device Mapper's; point-to-point
            with a random step filter (``p2point_step``): its first pass's
            step mask against the permute path bit for bit
  profile   device time of the new kernels by name and device launches per
            stage, from ``torch.profiler`` (last: its hooks slow every later
            launch); each held phase's last solve graph replayed under it
            (device ms and launches per ICP iteration, the in-graph
            kernels' device time), then the ``solve_device_per_iteration``
            line beside the numbers from before the commit kernel; the
            ``step_chain_launches`` line (the step chain's device launches
            per matcher pass, both paths, and per steady scan); then the
            ``phase_split`` line: the SurfaceNormal radius branch stage by
            stage, ms between CUDA events and device launches

The sequence is 18 scans of a ray-cast lidar (64 rings x 768 azimuths =
49,152 rays) in an analytic hall of 60 x 25 x 5 m with box obstacles, made
with numpy from ``--seed``.  The hall is dense enough that most search
windows reach their cap ``W`` (the stress case); the kernels phase also
holds every kernel shape against its plain version on a sparser seeded
cloud of the same capacities where no window overflows, which is where the
search is exact.  The brute-force k-NN kernel is held against its plain
version on a map built the way the default config builds it (the first scan
whole, every second scan gated at 0.15 m from the map) with twins planted
across the borders of its reference ranges, at the three shapes that path
gives it and at every split of the references the wrapper can choose, plus
a 2-D case, ragged ones, k = 32, a self-search against the general call, one
valid query, no valid reference and fewer references than one range.  The
standalone eigensolve is held on the covariances of that map's k = 10
neighbourhoods, built as the SurfaceNormal filter's k-NN branch builds them.
The
sweep is also run with windows of one chunk, of exactly one chunk's length
and of four chunks on clouds of twins (ties across chunk borders), where
windows overflow and where they do not.

In the ``kernels`` line, ``replaces`` gives file:line inside the JAX
reference package that stands beside the port.

Bounds use the published peaks of one H100 SXM: 67 TFLOP/s float32 outside
the tensor cores and 3.35 TB/s of device memory.
"""
from __future__ import annotations

import argparse
import contextlib
import inspect
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

PEAK_F32_FLOPS = 67.0e12
# float64 outside the tensor cores (NVIDIA's H100 SXM data sheet; the
# guide's table has no float64 rate)
PEAK_F64_FLOPS = 34.0e12
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

MIN_REPS_UNDER_1MS = 30


def time_cuda_stats(fn, reps: int = 7, warmup: int = 2):
    """``(min, median, max)`` milliseconds of ``fn()`` between CUDA events;
    what turns out to take under 1 ms is repeated at least
    ``MIN_REPS_UNDER_1MS`` times."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    while len(out) < reps:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
        if len(out) == reps and statistics.median(out) < 1.0:
            reps = max(reps, MIN_REPS_UNDER_1MS)
    return min(out), statistics.median(out), max(out)


def time_cuda(fn, reps: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of ``fn()`` between CUDA events."""
    return time_cuda_stats(fn, reps, warmup)[1]


def sm_clock_under_load(fn, seconds: float = 0.6):
    """The SM clock in MHz as ``nvidia-smi`` reads it while ``fn`` is
    launched in a loop (the highest of the readings taken after the first
    0.2 s), or None if it gives no reading."""
    import threading
    readings, stop = [], threading.Event()

    def poll():
        while not stop.is_set():
            r = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm",
                 "--format=csv,noheader,nounits"],
                capture_output=True, text=True)
            readings.append((time.time(), r.stdout.strip().splitlines()))
    th = threading.Thread(target=poll)
    t0 = time.time()
    th.start()
    while time.time() - t0 < seconds:
        for _ in range(20):
            fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    vals = [float(v[0]) for t, v in readings
            if v and t - t0 > 0.2 and v[0].replace(".", "").isdigit()]
    return max(vals) if vals else None


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


def _ptxas_line(line: str) -> str:
    """A line of ``ptxas -v`` made short: a mangled kernel name becomes
    ``name<template arguments>``."""
    m = re.search(r"\d+([a-z_]+_kernel)I((?:Li\d+E)+)E", line)
    if m:
        return f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2)))}>"
    return line.replace("ptxas info    : ", "").strip()[:100]


def phase_build():
    from norlab_icp_mapper_tpu_torch.ops import _build
    t0 = time.time()
    _build.start_builds()
    for name in _build.KERNEL_SOURCES:
        _build.load(name)
    secs = time.time() - t0
    regs = {}
    for name, log in _build.build_logs.items():
        # per kernel: its name with template arguments, spills, registers
        # and shared memory
        regs[name] = [_ptxas_line(ln) for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln
                      or "Compiling entry" in ln][:36]
    for name, log in _build.build_logs.items():
        spills = [ln for ln in log.splitlines() if "bytes spill" in ln
                  and "0 bytes spill stores, 0 bytes spill loads" not in ln]
        check(not spills, f"build: {name}.cu spills registers: {spills[:2]}")
        check("bytes spill" in log, f"build: no ptxas report for {name}.cu")
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
               replaces_line, exact=False, overflows=False):
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
    if overflows:
        check(int(ov) > 0, f"{name}: no tile overflows on the cloud made "
                           "for the overflowing case")
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
        qx_s, qm_s, pack, r_t, q_tile, Wc, S._BLOCK_QUERIES)
    n_pad = q_s.shape[0]
    before = (S.sweep_knn.launches, dict(S.sweep_knn.launches_by_shape))
    # the kernel's chunks and their merge, walked in plain tensor
    # operations on the kernel's own windows: the kernel's d2 must equal
    # them bit for bit, and its indices are the pack's fourth lane at the
    # plain positions
    chunks, chunk = S.chunking(max(Wc, 1))
    d_c, pos_c = S.search_chunked_plain(q_s, qm_s, pack.ref_s, b_start, b_end,
                                        r2, k, S._BLOCK_QUERIES, chunks, chunk)
    d_l, i_l = S._search_kernel(q_s, qm_s, pack.ref_s, b_start, b_end, r2, k,
                                n_pad, Wc)
    check(torch.equal(d_l, d_c), f"{name}: the kernel's d2 differs from the "
                                 "chunked plain search on the same windows")
    ids_c = torch.where(pos_c >= 0,
                        pack.ref_order[pos_c.clamp(min=0).long()],
                        torch.full_like(pos_c, -1).long())
    idx_mismatch = int((i_l != ids_c).sum())
    check(idx_mismatch == 0, f"{name}: {idx_mismatch} indices differ from "
                             "the chunked plain search on the same windows")
    lo_ms, ms, hi_ms = time_cuda_stats(lambda: S._search_kernel(
        q_s, qm_s, pack.ref_s, b_start, b_end, r2, k, n_pad, Wc))
    wrapper_ms = time_cuda(lambda: S.sweep_knn(q_srt, ref, qm_srt, rmask, **kw))
    plain_ms = time_cuda(lambda: S._search_plain(
        q_s, qm_s, pack.ref_s, t_start, t_end, live, r2, k, q_tile),
        reps=2, warmup=1)

    # the bound, from this run's windows
    spans = (b_end - b_start)
    valid_per_block = qm_s.view(-1, S._BLOCK_QUERIES).sum(1)
    pairs = int((spans * valid_per_block).sum())
    flops_pair = 3 * dim  # D subtractions, D products, D-1 sums, 1 compare
    n_valid_ref = int(pack.n_valid)
    n = query.shape[0]
    # queries and their mask, the packed sorted references (16 bytes each),
    # the windows, and per query k distances (f32) and k indices (i64)
    bytes_moved = (n * dim * 4 + n + n_valid_ref * 16
                   + 2 * 4 * spans.shape[0] + n * k * 12)
    ops_ms = pairs * flops_pair / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    live_spans = spans[valid_per_block > 0].float()
    t_spans = (t_end - t_start)[live].float()
    res = {
        "phase": "kernel_case", "case": name, "D": dim, "k": k,
        "N": n, "M": ref.shape[0], "valid_queries": int(qmask.sum()),
        "valid_refs": n_valid_ref, "radius": radius, "q_tile": q_tile,
        "W": W, "chunks": chunks, "chunk": chunk,
        "overflow": int(ov), "overflow_plain": int(ov_p),
        "max_abs_err_d2": max_err, "tolerance_d2": tol,
        "max_abs_err_d2_from_idx": idx_err,
        "frac_idx_equal": frac_same, "kernel_ms": ms,
        "kernel_ms_min_med_max": [lo_ms, ms, hi_ms],
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


# torch.profiler work waits here until the mapping phases are over: once the
# profiler has run, its tracing hooks stay attached to the process and every
# later launch costs the host more (the ICP loop, which is bound by the
# host's launch rate, ran 15-50 % slower per iteration after it).  Launches
# made here fall outside every reading of the wrappers' counters.
PROFILE_JOBS = []  # ("device_ms" or "launches", key, fn, kernel name part)


def phase_profile():
    """Device time of the kernels by name and device launches per stage,
    as ``torch.profiler`` records them on the card."""
    out = {"phase": "profile", "kernel_device_ms": {}, "device_launches": {},
           "solve_device": {},
           "launches_counted_by": "torch.profiler device events"}
    for kind, key, fn, part in PROFILE_JOBS:
        if kind == "device_ms":
            out["kernel_device_ms"][key] = kernel_device_ms(fn, part)
        elif kind == "solve":
            out["solve_device"][key] = solve_device_profile(*fn)
        else:
            out["device_launches"][key] = count_device_launches(fn)
    PROFILE_JOBS.clear()
    emit(out)
    for name, stage in PHASE_SPLIT["stages"].items():
        stage["device_launches"] = out["device_launches"].pop(
            f"phase_split/{name}")
    emit(PHASE_SPLIT)
    return out


def kernel_device_ms(fn, name_part, reps=10):
    """Mean device time in ms of the kernels whose name holds ``name_part``
    over ``reps`` calls of ``fn``, as ``torch.profiler`` records it (the
    launch path on the host is not in it); None if none was recorded."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = [e.device_time_total / e.count for e in prof.key_averages()
          if name_part in e.key and e.device_time_total > 0]
    return max(us) / 1e3 if us else None


def hold_normals(name, ev_k, n_k, ev_p, n_p, rows, r2):
    """Eigenvalues and normals of kernel and plain version on ``rows``.
    ``r2`` is the squared radius of the neighbourhoods (a number, or one per
    row), which bounds every entry of their covariances.  Tolerances come
    from it, not from bit identity: ``acosf`` / ``cosf`` differ from
    PyTorch's by ulps and nvcc contracts products and sums.
    Eigenvalues: their sum to 1e-5 r^2 everywhere; each to 1e-5 r^2 where
    both gaps of the plain spectrum exceed 1e-3 r^2 (all of them at D = 2,
    whose closed form has no acos), and to 1e-4 r^2 elsewhere: near a double
    eigenvalue acos is ill conditioned (acos(1 - x) ~ sqrt(2 x)), so an ulp
    of its argument moves the angle by up to 3.5e-4 and the pair by about
    1e-4 of the spectrum's spread, itself below r^2 / 2.
    Normals: |n_k . n_p| >= 1 - 1e-5 where the two smallest eigenvalues are
    1e-3 r^2 apart; sign flips are counted and must stay below 0.1 % of the
    rows."""
    dim = ev_p.shape[1]
    r2 = torch.as_tensor(r2, dtype=torch.float32,
                         device=ev_p.device).expand(ev_p.shape[0])

    def worst(err, sel):
        """Largest error on ``sel`` and the largest in units of r^2."""
        if not sel.any():
            return 0.0, 0.0
        return float(err[sel].max()), float((err[sel] / r2[sel]).max())

    err = (ev_k - ev_p).abs().amax(1)
    trace_err, trace_rel = worst((ev_k.sum(1) - ev_p.sum(1)).abs(), rows)
    gap0 = (ev_p[:, 1] - ev_p[:, 0]) > 1e-3 * r2
    well = rows & gap0
    if dim == 3:
        well = well & ((ev_p[:, 2] - ev_p[:, 1]) > 1e-3 * r2)
    else:
        well = rows
    ev_err_well, well_rel = worst(err, well)
    ev_err_all, all_rel = worst(err, rows)
    check(trace_rel <= 1e-5, f"{name}: the eigenvalues' sum differs from "
                             f"the plain version's by {trace_rel} r^2")
    check(well_rel <= 1e-5, f"{name}: eigenvalues differ by {well_rel} r^2 > "
                            "1e-5 r^2 where the spectrum is simple")
    check(all_rel <= 1e-4, f"{name}: eigenvalues differ by {all_rel} r^2 > "
                           "1e-4 r^2 near a double eigenvalue")
    sel = rows & gap0
    dots = (n_k * n_p).sum(1)[sel]
    flips = int((dots < 0).sum())
    min_dot = float(dots.abs().min()) if sel.any() else 1.0
    check(min_dot >= 1 - 1e-5, f"{name}: a normal differs from the plain "
                               f"version's, |dot| = {min_dot}")
    n_rows = int(rows.sum())
    check(flips <= 1e-3 * n_rows, f"{name}: {flips} normals of {n_rows} have "
                                  "the other sign than the plain version's")
    unit = float((torch.linalg.norm(n_k[rows], dim=1) - 1).abs().max())
    check(unit <= 1e-5, f"{name}: a normal is not of unit length ({unit})")
    return {"max_abs_err_evals_simple_spectrum": ev_err_well,
            "max_abs_err_evals": ev_err_all, "max_abs_err_trace": trace_err,
            "max_err_evals_simple_spectrum_over_r2": well_rel,
            "max_err_evals_over_r2": all_rel,
            "tolerance_evals_over_r2": [1e-5, 1e-4],
            "rows_near_a_double_eigenvalue": int((rows & ~well).sum()),
            "rows_compared_for_normals": int(sel.sum()),
            "min_abs_dot": min_dot, "sign_flips": flips}


def pca_windows(qp, r, q_tile, W):
    """The windows of the self-neighbourhood form from the wrapper's
    ``sweep_windows``: per tile of ``q_tile`` sorted queries ``(start,
    end)``, per block of the kernel's queries ``(start, end, valid
    queries)``.  A block of the kernel finds the same ones by binary search
    (the port's CPU tests hold the two against each other)."""
    from norlab_icp_mapper_tpu_torch.ops import nn_sweep as S
    from norlab_icp_mapper_tpu_torch.ops import pca as P
    n = qp.ref_s.shape[0]
    pad = -(-n // q_tile) * q_tile - n
    qx_s = S.pad_rows(qp.ref_xs, pad, S.BIG)
    qm_s = S.pad_rows(qp.ref_mask_s, pad, False)
    r_t = torch.tensor(r, dtype=torch.float32, device=qx_s.device)
    t_start, t_end, _, _, b_start, b_end = S.sweep_windows(
        qx_s, qm_s, qp, r_t, q_tile, W, P._BLOCK_QUERIES)
    return (t_start.long(), t_end.long(), b_start.long(), b_end.long(),
            qm_s.view(-1, P._BLOCK_QUERIES).sum(1))


def cov_oracle_errors(pts, qp, stats_k, stats_p, r, r2, q_tile, W, rng,
                      sample=2048):
    """Covariances of kernel and plain version against float64 on a sample
    of valid queries: the neighbour set is the f32 gate's on the tile's
    (possibly truncated) window, the arithmetic float64 on the original
    coordinates.  Beside them the error of the raw-moment form
    ``S(x x^T)/n - mean mean^T`` about the cloud's centroid in f32, summed
    over the same neighbours (the form this kernel had before)."""
    dim = pts.shape[1]
    n_q = int(qp.n_valid)
    pick = torch.from_numpy(np.sort(rng.choice(n_q, min(sample, n_q),
                                               replace=False))).to(pts.device)
    start, end, _, _, _ = pca_windows(qp, r, q_tile, W)
    t = pick // q_tile
    s0, e0 = start[t], end[t]
    width = int((e0 - s0).max())
    idx = s0[:, None] + torch.arange(width, device=pts.device)[None, :]
    inside = idx < e0[:, None]
    idx = idx.clamp(max=qp.ref_s.shape[0] - 1)
    ref_c = qp.ref_s[:, :dim]
    q = ref_c[pick]
    d = ref_c[idx][:, :, 0] - q[:, None, 0]
    s = d * d
    for a in range(1, dim):
        d = ref_c[idx][:, :, a] - q[:, None, a]
        s = s + d * d
    w = (inside & (s <= r2))
    rows = qp.ref_order[pick]
    x64 = pts.double()[qp.ref_order[idx]]  # [S, width, D], original frame
    w64 = w.double()[..., None]
    cnt = w64.sum(1).clamp(min=1)
    mean = (x64 * w64).sum(1) / cnt
    dev = (x64 - mean[:, None, :]) * w64
    cov = torch.einsum("nkd,nke->nde", dev, dev) / cnt[..., None]
    check(bool((w.sum(1).float() == stats_k.cnt[rows]).all()),
          "oracle: the sampled neighbour sets differ from the kernel's counts")
    # the raw-moment form in f32 about the centroid, same neighbours
    xc = ref_c[idx] * w[..., None]
    cf = w.float().sum(1).clamp(min=1)
    m1 = xc.sum(1) / cf[:, None]
    m2 = torch.einsum("nkd,nke->nde", xc, xc) / cf[:, None, None]
    cov_raw = m2 - m1[:, :, None] * m1[:, None, :]
    return {"oracle_sample": int(pick.shape[0]),
            "max_abs_err_cov_kernel_vs_f64":
                float((stats_k.cov[rows].double() - cov).abs().max()),
            "max_abs_err_cov_plain_vs_f64":
                float((stats_p.cov[rows].double() - cov).abs().max()),
            "max_abs_err_cov_raw_moment_form_vs_f64":
                float((cov_raw.double() - cov).abs().max()),
            "max_abs_err_mean_kernel_vs_f64":
                float((stats_k.mean[rows].double() - mean).abs().max())}


def pca_case(name, pts, mask, radius, q_tile, W, on_path: bool, rng,
             exact=False, knn=10, oracle_tol=None):
    """One radius_pca shape: every output of the one-launch kernel against
    the plain version, covariances against float64, then timed."""
    from norlab_icp_mapper_tpu_torch.ops import nn_sweep as S
    from norlab_icp_mapper_tpu_torch.ops import pca as P
    dim = pts.shape[1]
    n = pts.shape[0]
    min_count = min(knn, 3)
    before = P.radius_pca.launches
    args = (pts, pts, mask, mask, radius, q_tile, W, min_count)
    k = P._radius_pca(*args, force_plain=False)
    torch.cuda.synchronize()
    check(P.radius_pca.launches == before + 1,
          f"{name}: the wrapper made {P.radius_pca.launches - before} "
          "launches, not 1")
    p = P._radius_pca(*args, force_plain=True)
    torch.cuda.synchronize()
    check(int(k.overflow) == int(p.overflow),
          f"{name}: overflow {int(k.overflow)} differs from the plain "
          f"version's {int(p.overflow)}")
    if exact:
        check(int(k.overflow) == 0, f"{name}: {int(k.overflow)} tiles "
              "overflow on the cloud made for the exact case")
    count_flips = int((k.cnt != p.cnt).sum())
    check(count_flips == 0,
          f"{name}: {count_flips} neighbour counts differ from the plain "
          "version (the distance gate is meant to agree bit for bit)")
    r2 = float(np.float32(radius * radius))
    eps = float(np.finfo(np.float32).eps)
    # mean: 1e-6 r of summation order, and the rounding of q + s + c at |q|
    mean_tol = 1e-6 * radius + 4 * eps * torch.linalg.norm(pts, dim=1)
    mean_excess = float(((k.mean - p.mean).abs().amax(1) - mean_tol).max())
    check(mean_excess <= 0, f"{name}: a mean differs from the plain "
                            f"version's by {mean_excess} above its tolerance")
    cov_err = float((k.cov - p.cov).abs().max())
    check(cov_err <= 1e-5 * r2, f"{name}: covariances differ by {cov_err} > "
                                f"{1e-5 * r2}")
    for x in (k.cnt, k.mean, k.cov, k.evals, k.normals):
        check(not bool(x[~mask].any()),
              f"{name}: a row of an invalid point is not zero")
    few = mask & (k.cnt < min_count)
    fb = torch.zeros(dim, device=pts.device)
    fb[dim - 1] = 1.0
    check(bool((k.normals[few] == fb).all()),
          f"{name}: a neighbourhood of fewer than {min_count} points does "
          "not carry the unit normal along the last axis")
    rec_n = hold_normals(name, k.evals, k.normals, p.evals, p.normals,
                         mask & ~few, r2)
    r = float(np.float32(radius))
    qp = S.presort_ref(pts, mask)
    rec_o = cov_oracle_errors(pts, qp, k, p, r, r2, q_tile, min(W, n), rng)
    if oracle_tol is not None:
        check(rec_o["max_abs_err_cov_kernel_vs_f64"] <= oracle_tol,
              f"{name}: kernel covariance is "
              f"{rec_o['max_abs_err_cov_kernel_vs_f64']} m^2 from float64 "
              f"(> {oracle_tol})")

    # the launch alone (packs built), the whole wrapper, the plain version
    Wc = min(W, n)

    def launch():
        return P._stats_kernel(qp, qp, r, r2, q_tile, Wc, min_count)
    lo_ms, ms, hi_ms = time_cuda_stats(launch)
    PROFILE_JOBS.append(("device_ms", name, launch, "radius_pca_kernel"))
    wrapper_ms = time_cuda(lambda: P.radius_pca_normals(
        pts, pts, mask, mask, max_radius=radius, q_tile=q_tile, W=W,
        min_count=min_count))
    pack_ms = time_cuda(lambda: S.presort_ref(pts, mask))
    plain_ms = time_cuda(lambda: P._stats_plain(qp, qp, r, r2, q_tile, Wc,
                                                min_count), reps=2, warmup=1)
    P.radius_pca.launches = before

    _, _, start, end, per_block = pca_windows(qp, r, q_tile, Wc)
    live = per_block > 0
    spans = (end - start)[live]
    per_block = per_block[live]
    pairs = int((spans * per_block).sum())
    hits = int(k.cnt.sum())
    n_valid = int(mask.sum())
    # per pair the distance test (D subtractions, D products, D - 1 sums, a
    # compare); per pair inside the radius the count, D sums and
    # D (D + 1) / 2 multiply-adds
    hit_ops = 1 + dim + dim * (dim + 1)
    flops = pairs * 3 * dim + hits * hit_ops
    # the pack of the valid points, the two counts and the centre read
    # once; the five outputs and the overflow word written once
    bytes_moved = (n_valid * 16 + 16 + 4 * dim
                   + n * 4 * (1 + 3 * dim + dim * dim) + 4)
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    rec = {
        "phase": "kernel_case", "case": name, "kernel": "radius_pca",
        "D": dim, "N": n, "valid": n_valid, "radius": radius,
        "q_tile": q_tile, "W": W, "min_count": min_count,
        "overflow": int(k.overflow), "overflow_plain": int(p.overflow),
        "count_flips": count_flips, "max_abs_err_cov": cov_err,
        "tolerance_cov": 1e-5 * r2,
        "max_abs_err_mean": float((k.mean - p.mean).abs().max()),
        "degenerate_rows": int(few.sum()),
        "mean_neighbours": hits / max(n_valid, 1),
        "kernel_ms": ms, "kernel_ms_min_med_max": [lo_ms, ms, hi_ms],
        "wrapper_ms": wrapper_ms, "pack_ms": pack_ms, "plain_ms": plain_ms,
        "pairs": pairs, "hits": hits,
        "gpairs_per_s": pairs / (ms * 1e-3) / 1e9,
        "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
        "bound_arithmetic": f"({pairs} pairs x {3 * dim} + {hits} hits x "
                            f"{hit_ops}) f32 operations / 67 TFLOP/s; "
                            f"{bytes_moved} bytes / 3.35 TB/s",
        "block_span_min_med_max": [float(spans.min()),
                                   float(spans.float().median()),
                                   float(spans.max())],
    }
    rec.update(rec_n)
    rec.update(rec_o)
    emit(rec)
    if not on_path:
        return None
    return {
        "name": f"radius_pca[D={dim}]", "route": "cuda",
        "source": "norlab_icp_mapper_tpu_torch/csrc/radius_pca.cu",
        "replaces": "ops/pca.py:136",
        "launches": 0, "max_abs_err": cov_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": None,
    }


def pca_two_clouds_case(name, query, qmask, ref, rmask, radius, q_tile, W,
                        knn=10):
    """The kernel's two-cloud form (a sorted query pack of its own) against
    the plain version: counts and overflow exactly, the rest as in
    ``pca_case``.  Not timed: the main path only has the self form."""
    from norlab_icp_mapper_tpu_torch.ops import pca as P
    min_count = min(knn, 3)
    before = P.radius_pca.launches
    args = (query, ref, qmask, rmask, radius, q_tile, W, min_count)
    k = P._radius_pca(*args, force_plain=False)
    p = P._radius_pca(*args, force_plain=True)
    torch.cuda.synchronize()
    P.radius_pca.launches = before
    check(int(k.overflow) == int(p.overflow),
          f"{name}: overflow {int(k.overflow)} differs from the plain "
          f"version's {int(p.overflow)}")
    count_flips = int((k.cnt != p.cnt).sum())
    check(count_flips == 0, f"{name}: {count_flips} neighbour counts differ "
                            "from the plain version")
    r2 = float(np.float32(radius * radius))
    eps = float(np.finfo(np.float32).eps)
    mean_tol = 1e-6 * radius + 4 * eps * torch.linalg.norm(query, dim=1)
    mean_excess = float(((k.mean - p.mean).abs().amax(1) - mean_tol).max())
    check(mean_excess <= 0, f"{name}: a mean differs from the plain "
                            f"version's by {mean_excess} above its tolerance")
    cov_err = float((k.cov - p.cov).abs().max())
    check(cov_err <= 1e-5 * r2, f"{name}: covariances differ by {cov_err}")
    for x in (k.cnt, k.mean, k.cov, k.evals, k.normals):
        check(not bool(x[~qmask].any()),
              f"{name}: a row of an invalid query is not zero")
    rec = hold_normals(name, k.evals, k.normals, p.evals, p.normals,
                       qmask & (k.cnt >= min_count), r2)
    rec.update({"phase": "kernel_case", "case": name, "kernel": "radius_pca",
                "D": query.shape[1], "N": query.shape[0], "M": ref.shape[0],
                "valid_queries": int(qmask.sum()),
                "valid_refs": int(rmask.sum()), "radius": radius,
                "q_tile": q_tile, "W": W, "overflow": int(k.overflow),
                "count_flips": count_flips, "max_abs_err_cov": cov_err,
                "queries_without_neighbour": int((qmask & (k.cnt == 0)).sum()),
                "mean_neighbours": float(k.cnt.sum() / qmask.sum())})
    emit(rec)


def library_eigh_ms(cov, chunk=16384):
    """The yardstick of the eigensolve: ``torch.linalg.eigh`` over the same
    matrices in batches of ``chunk`` (timed here, used nowhere in the port)."""
    return time_cuda(lambda: [torch.linalg.eigh(cov[i:i + chunk])
                              for i in range(0, cov.shape[0], chunk)],
                     reps=3, warmup=1)


def eig_case(name, cov, rows, r2, on_path: bool):
    """The standalone eigensolve (the PCA kernel's epilogue on its own)
    against the closed forms in tensor operations, then timed."""
    from norlab_icp_mapper_tpu_torch.ops import eigen as E
    dim = cov.shape[-1]
    wrapper, plain = ((E.sym_eig3_smallest, E.sym_eig3_plain) if dim == 3
                      else (E.sym_eig2_smallest, E.sym_eig2_plain))
    before = wrapper.launches
    ev_k, n_k = wrapper(cov)
    torch.cuda.synchronize()
    check(wrapper.launches == before + 1, f"{name}: no launch was counted")
    ev_p, n_p = plain(cov)
    rec = hold_normals(name, ev_k, n_k, ev_p, n_p, rows, r2)
    zero = torch.zeros((4, dim, dim), device=cov.device)
    iso = torch.eye(dim, device=cov.device)[None].repeat(4, 1, 1) * 0.25
    for label, A in (("zero", zero), ("isotropic", iso)):
        a, b = wrapper(A), plain(A)
        check(torch.equal(a[1], b[1]) and
              float((a[0] - b[0]).abs().max()) <= 1e-6,
              f"{name}: {label} matrices differ from the plain version")
    lo_ms, ms, hi_ms = time_cuda_stats(lambda: wrapper(cov))
    plain_ms = time_cuda(lambda: plain(cov), reps=5)
    PROFILE_JOBS.append(("device_ms", name, lambda: wrapper(cov),
                         "sym_eig_kernel"))
    PROFILE_JOBS.append(("launches", f"{name}/plain", lambda: plain(cov),
                         None))
    library_ms = library_eigh_ms(cov)
    wrapper.launches = before
    n = cov.shape[0]
    # a matrix read, eigenvalues and vector written; ~150 operations each
    bytes_moved = n * 4 * (dim * dim + 2 * dim)
    ops_ms = n * 150 / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    rec.update({
        "phase": "kernel_case", "case": name, "kernel": "sym_eig", "D": dim,
        "N": n, "kernel_ms": ms, "kernel_ms_min_med_max": [lo_ms, ms, hi_ms],
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "torch.linalg.eigh in batches of 16384 matrices",
        "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
        "bound_arithmetic": f"{bytes_moved} bytes / 3.35 TB/s; {n} x ~150 "
                            "f32 operations / 67 TFLOP/s",
    })
    emit(rec)
    if not on_path:
        return None
    return {
        "name": f"sym_eig[D={dim}]", "route": "cuda",
        "source": "norlab_icp_mapper_tpu_torch/csrc/sym_eig.cu",
        "replaces": "ops/eigen.py:29",
        "launches": 0, "max_abs_err": rec["max_abs_err_evals"], "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }


def count_device_launches(fn):
    """Device activities (kernels, copies, fills) that one call of ``fn``
    starts, counted by ``torch.profiler`` on the card; None where the
    profiler records no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)
    return n or None


IN_REPLAY_KERNELS = {"loop_commit": "loop_commit_kernel",
                     "kabsch": "kabsch_kernel",
                     "p2p_step": "p2p_step_kernel",
                     "philox": "philox_uniform_kernel",
                     "philox_keep": "philox_keep_kernel"}


def solve_device_profile(replay, body=None, body_len=1, iterations=None,
                         recapture=None):
    """One solve graph's replay (``replay()``) measured: its time between
    CUDA events per ICP iteration (``iterations``, else the solve's own
    count); under ``torch.profiler`` its device time and device activities
    (kernels, copies, fills) per iteration and the mean device time of each
    in-graph kernel of ``IN_REPLAY_KERNELS``.  The profiler sees every run
    of a WHILE node's body only in a graph made after it was first started
    in the process (a graph made before shows its body once per replay), so
    ``recapture()`` drops the cached graph after a first profiler session
    and the next replay captures it anew.  ``body()``, one run of the same
    body under the Python loop (``body_len`` iterations), counts the
    launches per iteration a second way.  None where the profiler records
    no device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    if recapture is not None:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]):
            torch.zeros(1, device="cuda").add_(1)
            torch.cuda.synchronize()
        recapture()
    res = replay()
    torch.cuda.synchronize()
    iters = int(iterations if iterations is not None else res[2])
    replay_ms = time_cuda(replay, reps=5, warmup=1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        res = replay()
        torch.cuda.synchronize()
    if iterations is None:
        iters = int(res[2])
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return None
    kernels = {}
    for name, part in IN_REPLAY_KERNELS.items():
        us = [e.device_time_total for e in dev if part in e.name]
        if us:
            kernels[name] = {"launches": len(us),
                             "mean_device_ms": sum(us) / len(us) / 1e3}
    busy_ms = sum(e.device_time_total for e in dev) / 1e3
    rec = {"iterations": iters, "replay_ms": replay_ms,
           "replay_ms_per_iteration": replay_ms / max(iters, 1),
           "device_ms": busy_ms,
           "device_ms_per_iteration": busy_ms / max(iters, 1),
           "device_launches": len(dev),
           "device_launches_per_iteration": len(dev) / max(iters, 1),
           "kernels": kernels}
    if body is not None:
        rec["eager_body_launches_per_iteration"] = \
            count_device_launches(body) / body_len
    return rec


PHASE_SPLIT = {}  # the phase_split record, waiting for its launch counts
SHARDED_SOLVE = {}  # the sharded solve graph's numbers, for the summary
SHARDED_STEP_PASS = {}  # the sharded step mask's launches per matcher pass
SHARDED_STEP_SOLVE = {}  # the sharded point-to-point step solve's replay


def phase_split(mp, knn, radius):
    """The SurfaceNormal radius branch at the path shape, stage by stage
    between CUDA events.  The line is printed by the profile phase, which
    adds the device launches of each stage as ``torch.profiler`` counts
    them."""
    from norlab_icp_mapper_tpu_torch.filters import core as F
    from norlab_icp_mapper_tpu_torch.ops import nn_sweep as S
    from norlab_icp_mapper_tpu_torch.ops import pca as P
    pts, mask = mp.positions, mp.mask
    W = 2048 if radius <= 1.0 else 4096
    st = {}

    def pack():
        st["qp"] = S.presort_ref(pts, mask)

    def launch():
        st["out"] = P._stats_kernel(
            st["qp"], st["qp"], float(np.float32(radius)),
            float(np.float32(radius * radius)), 1024, W, min(knn, 3))

    filt = F.filter_registry.create(
        "SurfaceNormalDataPointsFilter",
        {"knn": knn, "maxDist": radius, "keepEigenValues": 1})
    calls = P.radius_pca.launches
    filt.apply(mp)
    check(P.radius_pca.launches == calls + 1,
          "phase_split: the filter's radius branch is not one kernel launch")

    stages = [("centroid_sort_pack", pack), ("zero_fill_and_kernel", launch),
              ("whole_filter", lambda: filt.apply(mp))]
    for _, fn in stages:
        fn()
    torch.cuda.synchronize()
    ms = {name: time_cuda(fn, reps=20, warmup=3) for name, fn in stages}
    P.radius_pca.launches = calls
    for name, fn in stages:
        PROFILE_JOBS.append(("launches", f"phase_split/{name}", fn, None))
    PHASE_SPLIT.update({
        "phase": "phase_split", "N": pts.shape[0], "valid": int(mask.sum()),
        "radius": radius, "q_tile": 1024, "W": W,
        "launches_counted_by": "torch.profiler device events",
        "stages": {name: {"ms": t} for name, t in ms.items()}})


def default_like_map(scans, poses, min_dist=0.15):
    """The map as the default config builds it, in numpy: the first scan
    whole, then every second scan's points that lie at least ``min_dist``
    from the map so far (PointDistanceMapperModule; the default update
    condition merges about every second scan of this sequence)."""
    from scipy.spatial import cKDTree
    pts = None
    for s, p in list(zip(scans, poses))[::2]:
        w = (s @ p[:3, :3].T + p[:3, 3]).astype(np.float32)
        if pts is None:
            pts = w
            continue
        d, _ = cKDTree(pts).query(w)
        pts = np.concatenate([pts, w[d >= min_dist]])
    return pts


def library_knn(query, ref_valid, k, chunk=8192):
    """The yardstick: chunked ``torch.cdist`` + ``torch.topk`` over the
    valid references (timed here, used nowhere in the port)."""
    out = []
    for q0 in range(0, query.shape[0], chunk):
        d = torch.cdist(query[q0:q0 + chunk], ref_valid)
        out.append(torch.topk(d, min(k, ref_valid.shape[0]), dim=1,
                              largest=False))
    return out


DISPATCH_SLOTS_PER_PAIR = 9  # 3 sub, 3 mul, 2 add and one to rank, unfused
LANES = 132 * 4 * 32  # SMs x schedulers x lanes of an H100 SXM


def _hold_knn(name, d_k, i_k, d_p, i_p, query, qmask, ref, rmask, k):
    """One knn result against the plain version's: d2 bit-identical, -1
    exactly where the plain version has it, rows ascending, d2 recomputed
    from every returned index equal to the returned d2, neighbours valid;
    returns (max |d2 - plain|, indices differing at exact ties)."""
    dim = query.shape[1]
    fin = torch.isfinite(d_p)
    check(bool((torch.isfinite(d_k) == fin).all()),
          f"{name}: validity pattern differs from the plain version")
    max_err = float((d_k[fin] - d_p[fin]).abs().max()) if fin.any() else 0.0
    check(max_err == 0.0, f"{name}: d2 differs from the plain version's by "
                          f"{max_err} (bit-identical is required)")
    check(bool(((i_k == -1) == (i_p == -1)).all())
          and bool(((i_k >= 0) == fin).all()),
          f"{name}: -1 is not exactly where the plain version has it")
    if k > 1:
        asc = d_k[:, 1:] >= d_k[:, :-1]
        check(bool(asc.all()), f"{name}: a row is not ascending")
    hit = i_k >= 0
    qq = query[:, None, :].expand(-1, k, -1)[hit]
    rr = ref[i_k[hit]]
    d_idx = (rr[:, 0] - qq[:, 0]) ** 2
    for a in range(1, dim):
        d_idx = d_idx + (rr[:, a] - qq[:, a]) ** 2
    idx_err = float((d_idx - d_k[hit]).abs().max()) if hit.any() else 0.0
    check(idx_err == 0.0, f"{name}: d2 recomputed from the returned indices "
                          f"differs from the returned d2 by {idx_err}")
    if rmask is not None:
        check(bool(rmask[i_k[hit]].all()),
              f"{name}: a returned neighbour is an invalid reference")
    if qmask is not None:
        check(bool((~hit[~qmask]).all()),
              f"{name}: an invalid query has a neighbour")
    # with d2 bit-identical and every returned index holding its returned
    # d2, an index that differs from the plain version's is an exact tie
    return max_err, int(((i_k != i_p) & fin).sum())


def knn_case(name, query, qmask, ref, rmask, k, role=None,
             splits=(1, 2, 4, 8), time_it=True):
    """One knn shape: the wrapper, and the kernel at every split of the
    references the wrapper can choose, against the plain version (see
    ``_hold_knn``); a cloud searched against itself also through the
    general call; then timed."""
    from norlab_icp_mapper_tpu_torch.ops import nn as N
    dim = query.shape[1]
    before = (N.knn.launches, dict(N.knn.launches_by_shape))
    self_search = query is ref and qmask is rmask
    d_k, i_k = N.knn(query, ref, qmask, rmask, k=k)
    d_p, i_p = N.knn_plain(query, ref, qmask, rmask, k=k)
    max_err, ties = _hold_knn(name, d_k, i_k, d_p, i_p, query, qmask, ref,
                              rmask, k)
    pack = N.pack_refs(ref, rmask)
    qc = query.contiguous()
    qrows = N.query_rows(qmask)
    chosen = N.pick_splits(query.shape[0], k)
    check(chosen in splits, f"{name}: the wrapper's split {chosen} is not "
                            f"among the splits held against the plain version")
    ties_by_split = {}
    for sp in splits:
        for as_self in ([False, True] if self_search else [False]):
            d_s, i_s = N._knn_kernel(qc, qrows, pack, k, self_search=as_self,
                                     splits=sp)
            _, t = _hold_knn(f"{name}[splits={sp},self={as_self}]", d_s, i_s,
                             d_p, i_p, query, qmask, ref, rmask, k)
            ties_by_split[f"{sp}{'s' if as_self else ''}"] = t
    ref_valid = ref if rmask is None else ref[rmask]
    q_valid = query if qmask is None else query[qmask]
    n_vq, n_vr = q_valid.shape[0], ref_valid.shape[0]
    n, m = query.shape[0], ref.shape[0]
    pairs = n_vq * n_vr
    flops_pair = 3 * dim  # D subtractions, D products, D-1 sums, 1 compare
    # queries and their row list, the packed valid references (16 bytes
    # each) and the two counts, and per query k distances (f32) and k
    # indices (i64)
    bytes_moved = (n * dim * 4 + (n * 4 if qmask is not None else 0)
                   + n_vr * 16 + 16 + n * k * 12)
    ops_ms = pairs * flops_pair / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    rec = {
        "phase": "kernel_case", "case": name, "kernel": "knn_brute",
        "D": dim, "k": k, "N": n, "M": m, "valid_queries": n_vq,
        "valid_refs": n_vr, "self_search": self_search,
        "splits_chosen": chosen, "max_abs_err_d2": max_err,
        "idx_differing_at_exact_ties": ties,
        "idx_differing_at_exact_ties_by_split": ties_by_split,
        "frac_idx_equal": float((i_k == i_p).float().mean()),
        "pairs": pairs, "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms,
        "bound_arithmetic": f"{n_vq} valid queries x {n_vr} valid refs x "
                            f"{flops_pair} f32 operations / 67 TFLOP/s; "
                            f"{bytes_moved} bytes / 3.35 TB/s",
    }
    if not time_it:
        emit(rec)
        N.knn.launches, N.knn.launches_by_shape = before
        return None

    # kernel launch alone (pack and query rows built, as the callers have
    # them), the whole wrapper, the plain version and the library
    # yardstick, each between CUDA events after a warm-up
    def launch(sp=chosen):
        return N._knn_kernel(qc, qrows, pack, k, self_search=self_search,
                             splits=sp)
    lo, ms, hi = time_cuda_stats(launch, reps=7)
    by_split = {sp: time_cuda(lambda: launch(sp), reps=5) for sp in splits}
    wrapper_ms = time_cuda(lambda: N.knn(query, ref, qmask, rmask, k=k),
                           reps=5)
    plain_ms = time_cuda(lambda: N.knn_plain(query, ref, qmask, rmask, k=k),
                         reps=2, warmup=1)
    library_ms = None
    if n_vr > 0 and n_vq > 0:
        library_ms = time_cuda(lambda: library_knn(q_valid, ref_valid, k),
                               reps=3, warmup=1)
    rec.update({
        "kernel_ms": ms, "kernel_ms_min_med_max": [lo, ms, hi],
        "kernel_ms_by_split": by_split, "wrapper_ms": wrapper_ms,
        "plain_ms": plain_ms, "library_ms": library_ms,
        "library": "chunked torch.cdist + torch.topk over the valid "
                   "references (8192 queries per chunk)",
        "gpairs_per_s": pairs / (ms * 1e-3) / 1e9,
    })
    if role == "point_distance":
        # the dispatch ceiling of the unfused form: lanes x clock / 9
        mhz = sm_clock_under_load(launch)
        rec["sm_clock_under_load_mhz"] = mhz
        if mhz:
            ceil = LANES * mhz * 1e6 / DISPATCH_SLOTS_PER_PAIR
            rec["dispatch_ceiling_gpairs_per_s"] = ceil / 1e9
            rec["share_of_dispatch_ceiling"] = \
                pairs / (ms * 1e-3) / ceil
    emit(rec)
    N.knn.launches, N.knn.launches_by_shape = before
    if role is None:
        return None
    return {
        "name": f"knn_brute[D={dim},k={k},{role}]", "route": "cuda",
        "source": "norlab_icp_mapper_tpu_torch/csrc/knn_brute.cu",
        "replaces": "ops/nn_pallas.py:53",
        "launches": 0, "max_abs_err": max_err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": max(ops_ms, bytes_ms),
        "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
        "library_ms": library_ms,
    }


def knn_covariances(pos, mask, k):
    """What the SurfaceNormal filter's k-NN branch hands the eigensolve: the
    covariances of each point's ``k`` nearest neighbours in the cloud itself
    (``filters/core.py``, the same tensor operations).  ``(cov [N, D, D],
    valid rows, squared distance of each row's farthest neighbour)``."""
    from norlab_icp_mapper_tpu_torch.ops.nn import knn
    d2, idx = knn(pos, pos, mask, mask, k=k)
    neigh = pos[torch.clamp(idx, min=0)]
    w = (idx >= 0).to(torch.float32)[..., None]
    cnt = torch.clamp(w.sum(dim=1), min=1.0)
    mean = (neigh * w).sum(dim=1) / cnt
    centered = (neigh - mean[:, None, :]) * w
    cov = torch.einsum("nkd,nke->nde", centered, centered) / cnt[..., None]
    reach = torch.where(idx >= 0, d2, torch.zeros_like(d2)).amax(dim=1)
    return cov, mask & (reach > 0), reach.clamp(min=1e-12)


def knn_cases(scans, poses, rng, dev):
    """The brute-force kernel at the default path's three shapes on a
    map-sized cloud with twins planted across every range border, then a
    2-D case, ragged ones and the corner cases of the schedule."""
    import norlab_icp_mapper_tpu_torch as nt
    world = default_like_map(scans, poses)
    # twins astride the borders of 2, 4 and 8 ranges (the valid points are
    # packed in this order, so the packed position is the row): the lower
    # index must win on both sides
    n_w = world.shape[0]
    for sp in (2, 4, 8):
        per = -(-(-(-n_w // sp)) // 16) * 16
        for b in range(per, n_w - 2, per):
            world[b] = world[b - 1]
            world[b + 1] = world[b - 2]
    cap = nt.bucket_capacity(world.shape[0] + SCAN_CAPACITY)
    mp = nt.PointBatch.from_numpy(world, capacity=cap, device=dev)
    sc = nt.PointBatch.from_numpy(scans[-1], capacity=SCAN_CAPACITY,
                                  device=dev)
    scan_m = nt.se3.apply(torch.from_numpy(poses[-1]), sc)
    # the reading after RandomSampling 0.75
    keep = torch.from_numpy(rng.random(SCAN_CAPACITY) < 0.75).to(dev)
    entries = [
        knn_case("default_matcher_k1", scan_m.positions, scan_m.mask & keep,
                 mp.positions, mp.mask, 1, role="matcher"),
        knn_case("default_point_distance_k1", scan_m.positions, scan_m.mask,
                 mp.positions, mp.mask, 1, role="point_distance"),
        knn_case("default_normals_k10", mp.positions, mp.mask, mp.positions,
                 mp.mask, 10, role="normals"),
        eig_case("eigensolve_knn_covariances",
                 *knn_covariances(mp.positions, mp.mask, 10), on_path=True),
    ]
    q2 = torch.from_numpy(
        rng.uniform(-20, 20, size=(5000, 2)).astype(np.float32)).to(dev)
    r2 = torch.from_numpy(
        rng.uniform(-20, 20, size=(7000, 2)).astype(np.float32)).to(dev)
    knn_case("knn_2d_k5", q2, torch.from_numpy(rng.random(5000) > 0.1).to(dev),
             r2, torch.from_numpy(rng.random(7000) > 0.2).to(dev), 5)
    # ragged: N and M multiples of neither the block (128) nor the tile
    q3 = torch.from_numpy(rng.normal(size=(1237, 3)).astype(np.float32)).to(dev)
    r3 = torch.from_numpy(rng.normal(size=(1531, 3)).astype(np.float32)).to(dev)
    # duplicates, so that exact ties occur
    r3[700:760] = r3[100:160]
    rm3 = torch.from_numpy(rng.random(1531) > 0.3).to(dev)
    knn_case("knn_ragged_k10", q3, None, r3, rm3, 10)
    knn_case("knn_ragged_k32", q3, None, r3, rm3, 32, time_it=False)
    knn_case("knn_ragged_self_k32", r3, rm3, r3, rm3, 32, time_it=False)
    few = torch.zeros(1531, dtype=torch.bool, device=dev)
    few[[3, 400, 401, 777, 1000, 1500, 1530]] = True
    # 7 references: fewer than k, and fewer than one of 8 ranges
    knn_case("knn_ragged_7_valid_refs_k10", q3,
             torch.from_numpy(rng.random(1237) > 0.5).to(dev), r3, few, 10)
    knn_case("knn_7_valid_refs_k1", q3, None, r3, few, 1, time_it=False)
    one_q = torch.zeros(1237, dtype=torch.bool, device=dev)
    one_q[611] = True
    for k in (1, 10):
        knn_case(f"knn_one_valid_query_k{k}", q3, one_q, r3, rm3, k,
                 time_it=False)
        knn_case(f"knn_no_valid_reference_k{k}", q3, None, r3,
                 torch.zeros(1531, dtype=torch.bool, device=dev), k,
                 time_it=False)
    return entries



def hall_os1_cell(dev, rng, n_scans=64, points=370_000):
    """The benchmark's default cell's data (``port_bench``'s scene of
    ``configs/os1_default.json``: the OS1-64 patrolling the hall): a map as
    its set-up leaves one, the union of ``n_scans`` scans around the first
    lap, one point per 0.1 m voxel, cut to ``points``; and one more scan
    (sensor frame, 65,536 rays) with its true pose."""
    sys.path.insert(0, os.path.join(HERE, "port_bench"))
    from harness import manifest
    from harness.scene import Scene
    scene = Scene(manifest.config("os1_default"), dev)
    lap = scene.scans_per_lap
    idx = [i * lap // n_scans for i in range(n_scans)] + [lap + lap // 3]
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(rng.integers(2 ** 31)))
    scans = scene.ray_cast(idx, gen).cpu().numpy()
    poses = [scene.true_pose(j) for j in idx]
    pts = numpy_map(list(scans[:-1]), poses[:-1], voxel=0.1)
    if pts.shape[0] > points:
        pts = pts[np.sort(rng.choice(pts.shape[0], points, replace=False))]
    return pts, scans[-1], poses[-1]


def knn_grid_case(name, query, qmask, ref, rmask):
    """The grid search at one shape: ``knn_grid`` (grid kernel and its
    fallback) against ``knn_brute`` on the same inputs bit for bit (d2 and
    index on every row), the plain version on the card against both, with
    the same fallback count; then timed beside the brute-force kernel, the
    plain version and the bound."""
    from norlab_icp_mapper_tpu_torch.ops import nn as N
    from norlab_icp_mapper_tpu_torch.ops import nn_grid as G
    before = (G.knn_grid.launches, dict(G.knn_grid.launches_by_shape),
              N.knn.launches, dict(N.knn.launches_by_shape))
    dim = query.shape[1]
    n, m = query.shape[0], ref.shape[0]
    t0 = time.time()
    pack = G.build_grid_pack(ref, rmask)
    torch.cuda.synchronize()
    first_build_s = time.time() - t0
    build_ms = time_cuda(lambda: G.build_grid_pack(ref, rmask), reps=5)
    d_b, i_b = N.knn(query, ref, qmask, rmask, k=1)
    qc = query.contiguous()
    qrows = N.query_rows(qmask)

    stats = torch.zeros(2, dtype=torch.int64, device=query.device)
    d_g, i_g = G.knn_grid(query, qmask, pack, stats)
    torch.cuda.synchronize()
    same_d = bool(torch.equal(d_g.view(torch.int32), d_b.view(torch.int32)))
    same_i = bool(torch.equal(i_g, i_b))
    check(same_d and same_i,
          f"{name}: knn_grid differs from knn_brute (d2 equal: {same_d}, "
          f"index equal: {same_i})")
    queries, fallbacks = stats.tolist()
    d_p, i_p, fb_p = G.knn_grid_plain(query, qmask, pack)
    check(bool(torch.equal(d_p.view(torch.int32), d_b.view(torch.int32)))
          and bool(torch.equal(i_p, i_b)),
          f"{name}: the plain version differs from knn_brute on the card")
    check(fb_p == fallbacks, f"{name}: {fallbacks} fallbacks in the kernel, "
                             f"{fb_p} in the plain version")

    lo, ms, hi = time_cuda_stats(lambda: G.knn_grid(query, qmask, pack),
                                 reps=9)
    grid_ms = time_cuda(lambda: G._grid_kernel(qc, qrows, pack), reps=9)
    brute_ms = time_cuda(lambda: N._knn_kernel(qc, qrows, pack.knn_pack(),
                                               1), reps=5)
    plain_ms = time_cuda(lambda: G.knn_grid_plain(query, qmask, pack),
                         reps=2, warmup=1)
    n_vr = int(pack.n_valid)
    # every query row's coordinates and mask byte, every valid reference's
    # coordinates, a distance and an index out per row (port_bench's
    # nn_call_bytes)
    bytes_moved = n * (4 * dim + 1) + n_vr * 4 * dim + n * 8
    bound_ms = bytes_moved / PEAK_BYTES * 1e3
    rec = {
        "phase": "kernel_case", "case": name, "kernel": "knn_grid",
        "D": dim, "N": n, "M": m, "valid_queries": queries,
        "valid_refs": n_vr, "cells": int(pack.grid_i[3]),
        "grid_dims": pack.grid_i[:3].tolist(),
        "edge_m": float(pack.grid_f[3]), "shell_cap": G.SHELL_CAP,
        "fallbacks": fallbacks,
        "bit_identical_to_knn_brute": True,
        "search_ms": ms, "search_ms_min_med_max": [lo, ms, hi],
        "grid_kernel_ms": grid_ms, "knn_brute_ms": brute_ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_arithmetic": f"{bytes_moved} bytes / 3.35 TB/s",
        "share_of_bound": bound_ms / ms,
        "pack_build_ms": build_ms, "pack_first_build_s": first_build_s,
        "gpu": torch.cuda.get_device_name(0),
    }
    emit(rec)
    (G.knn_grid.launches, G.knn_grid.launches_by_shape, N.knn.launches,
     N.knn.launches_by_shape) = before
    return {
        "name": f"knn_grid[D={dim}]", "route": "cuda",
        "source": "norlab_icp_mapper_tpu_torch/csrc/knn_grid.cu",
        "replaces": "none (the unbounded k = 1 matcher of ops/nn_pallas.py:53)",
        "launches": 0, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
        "fallbacks": fallbacks,
    }


def knn_grid_cases(scans, poses, rng, dev):
    """The grid search at the default matcher's shape (the knn_brute
    cases' map and scan), and at the benchmark cell's: a 65,536-ray OS1
    scan moved by a prior's error (0.15 m, 1 degree) and at its true pose,
    after RandomSampling 0.75, against a ~370,000-point hall map; then
    corner cases.  Returns the kernel table's entry of the cell's shape."""
    import norlab_icp_mapper_tpu_torch as nt
    world = default_like_map(scans, poses)
    cap = nt.bucket_capacity(world.shape[0] + SCAN_CAPACITY)
    mp = nt.PointBatch.from_numpy(world, capacity=cap, device=dev)
    sc = nt.PointBatch.from_numpy(scans[-1], capacity=SCAN_CAPACITY,
                                  device=dev)
    scan_m = nt.se3.apply(torch.from_numpy(poses[-1]), sc)
    sampled = scan_m.mask & torch.from_numpy(
        rng.random(SCAN_CAPACITY) < 0.75).to(dev)
    knn_grid_case("default_matcher_k1", scan_m.positions, sampled,
                  mp.positions, mp.mask)
    hall, scan, true = hall_os1_cell(dev, rng)
    cap = nt.bucket_capacity(hall.shape[0] + 2 * scan.shape[0])
    hp = nt.PointBatch.from_numpy(hall, capacity=cap, device=dev)
    sc = nt.PointBatch.from_numpy(scan, device=dev)
    keep = torch.from_numpy(rng.random(scan.shape[0]) < 0.75).to(dev)
    entry = None
    for label, pose in (("prior", perturb(true, rng)), ("true_pose", true)):
        q = nt.se3.apply(torch.from_numpy(pose), sc)
        e = knn_grid_case(f"cell_matcher_k1_{label}", q.positions,
                          q.mask & keep, hp.positions, hp.mask)
        entry = entry or e
    # corner cases: 2-D, far queries (the fallback), an empty map
    q2 = torch.from_numpy(rng.uniform(-20, 20, size=(5000, 2)).astype(
        np.float32)).to(dev)
    r2 = torch.from_numpy(rng.uniform(-20, 20, size=(7000, 2)).astype(
        np.float32)).to(dev)
    knn_grid_case("grid_2d", q2, torch.from_numpy(rng.random(5000) > 0.1
                                                  ).to(dev), r2, None)
    far = scan_m.positions.clone()
    far[::97] += 40.0
    far[5, 0] = float("nan")
    knn_grid_case("grid_far_and_nan_queries", far, sampled, mp.positions,
                  mp.mask)
    knn_grid_case("grid_empty_map", scan_m.positions, scan_m.mask,
                  mp.positions, torch.zeros_like(mp.mask))
    return entry


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
    # windows of one chunk, of exactly one chunk's length and of W (four
    # chunks) on the dense hall, every second map point a twin of its
    # predecessor (twins are neighbours in the sorted order, so chunk
    # borders split them): the windows overflow and the result still equals
    # the plain version's
    twin_pos = mp.positions.clone()
    twin_pos[1::2] = twin_pos[0:-1:2]
    twin_mask = mp.mask.clone()
    twin_mask[1::2] = twin_mask[0:-1:2]
    for W in (1024, 2048, 8192):
        sweep_case(f"hall_twins_k3_W{W}", scan_m.positions, smask, twin_pos,
                   twin_mask, 3, 2.0, 1024, W, 112, overflows=True)
    sweep_case("hall_twins_k1_W8192", scan_m.positions, smask, twin_pos,
               twin_mask, 1, 2.0, 1024, 8192, 112, overflows=True)
    # the kernel's covariance must lie within 1e-5 m^2 of float64 here
    entries.append(pca_case("surface_normals_self", mp.positions, mp.mask,
                            1.0, 1024, 2048, on_path=True, rng=rng,
                            oracle_tol=1e-5))
    phase_split(mp, 10, 1.0)
    # the two-cloud form: the scan's points against the map
    pca_two_clouds_case("scan_against_map", scan_m.positions, smask,
                        mp.positions, mp.mask, 1.0, 1024, 2048)
    p2 = torch.from_numpy(
        rng.uniform(-20, 20, size=(4096, 2)).astype(np.float32)).to(dev)
    m2 = torch.from_numpy(rng.random(4096) > 0.1).to(dev)
    pca_case("small_2d", p2, m2, 1.0, 1024, 2048, on_path=False, rng=rng)
    # the standalone eigensolve on the radius covariances of both clouds
    # (the shape its main paths give it comes with the brute-force cases)
    from norlab_icp_mapper_tpu_torch.ops import pca as P
    cnt, _, cov, _ = P.radius_pca_plain(mp.positions, mp.positions, mp.mask,
                                        mp.mask, 1.0, 1024, 2048)
    eig_case("eigensolve_radius_covariances", cov, mp.mask & (cnt >= 3), 1.0,
             on_path=False)
    cnt2, _, cov2, _ = P.radius_pca_plain(p2, p2, m2, m2, 1.0, 1024, 2048)
    eig_case("eigensolve_2d", cov2, m2 & (cnt2 >= 3), 1.0, on_path=False)
    exact_cases(rng, dev)
    entries += knn_cases(scans, poses, rng, dev)
    entries.append(knn_grid_cases(scans, poses, rng, dev))
    entries.append(while_node_case())
    entries.append(loop_commit_case(rng))
    entries.append(kabsch_case(rng))
    entries.append(p2p_step_case(rng))
    entries.append(philox_case())
    entries.append(philox_keep_case())
    return entries


KABSCH_CASES = ("conditioned", "reflection", "rank2", "near_identity",
                "2d")


def kabsch_moments(rng, kind):
    """Seeded weighted pairs of one kind, as many as the reading's capacity,
    reduced to ``(H, mu_p, mu_q)`` in float32 the way the point-to-point
    minimizer reduces them (centred cross-covariance, weighted means)."""
    dim = 2 if kind == "2d" else 3
    n = SCAN_CAPACITY
    p = rng.normal(size=(n, dim)) * np.array([8.0, 4.0, 1.5][:dim]) + 20.0
    if kind == "rank2":
        p[:, 2] = 20.0  # a planar pair set
    angle = 1e-4 if kind == "near_identity" else 0.3
    if dim == 2:
        R = np.array([[np.cos(angle), -np.sin(angle)],
                      [np.sin(angle), np.cos(angle)]])
    else:
        a = rng.normal(size=3)
        a /= np.linalg.norm(a)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        R = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
    q = p @ R.T + rng.normal(size=(n, dim)) * 0.005 + 0.2
    if kind == "reflection":
        q[:, -1] = 2 * q[:, -1].mean() - q[:, -1]  # det(H) < 0
    w = rng.uniform(0.2, 1.0, size=n)
    mu_p = (w[:, None] * p).sum(0) / w.sum()
    mu_q = (w[:, None] * q).sum(0) / w.sum()
    H = ((p - mu_p) * w[:, None]).T @ (q - mu_q)
    return [torch.from_numpy(x.astype(np.float32)) for x in (H, mu_p, mu_q)]


def kabsch_ops(dim: int) -> int:
    """f32 operations of one problem, counted from ``csrc/kabsch.cu``: in
    3-D the 4x4 build (10), ``SWEEPS`` sweeps of six rotations of 55 each
    (angle 17, off-diagonal 12, the two diagonal entries 2, V 24), the
    choice of the column (15), its normalisation (12), R (30) and t (18);
    in 2-D the angle's pair, its norm and quotients (9) and t (8)."""
    from norlab_icp_mapper_tpu_torch.ops.kabsch import SWEEPS
    if dim == 2:
        return 17
    return 10 + SWEEPS * 6 * 55 + 15 + 12 + 30 + 18


def kabsch_case(rng):
    """``csrc/kabsch.cu`` against ``kabsch_plain`` on the same card tensors
    (the same operations in the same order: bit for bit), and both against
    the CPU's plain version and a float64 SVD, for each kind of ``H``; then
    the launch timed beside the plain version and ``torch.linalg.svd`` +
    ``det`` (the library's form, which makes the host wait)."""
    from norlab_icp_mapper_tpu_torch.ops.kabsch import kabsch, kabsch_plain
    dev = torch.device("cuda")
    before = kabsch.launches
    worst, timed = 0.0, None
    for kind in KABSCH_CASES:
        H, mp, mq = kabsch_moments(rng, kind)
        dim = H.shape[0]
        Hc, mpc, mqc = H.to(dev), mp.to(dev), mq.to(dev)
        k = kabsch(Hc, mpc, mqc)
        pc = kabsch_plain(Hc, mpc, mqc)
        cpu = kabsch_plain(H, mp, mq)
        torch.cuda.synchronize()
        Hd = H.double().numpy()
        U, _, Vt = np.linalg.svd(Hd)
        D = np.eye(dim)
        D[-1, -1] = np.linalg.det(Vt.T @ U.T)
        R64 = Vt.T @ D @ U.T
        err = float((k - pc).abs().max())
        worst = max(worst, err)
        kh = k.cpu().numpy()
        rec = {"phase": "kernel_case", "case": f"kabsch_{kind}",
               "kernel": "kabsch", "dim": dim, "max_abs_err_plain": err,
               "bit_identical_plain": bool(torch.equal(k, pc)),
               "max_abs_diff_cpu_plain": float((k.cpu() - cpu).abs().max()),
               "R_max_abs_diff_svd_float64": float(
                   np.abs(kh[:dim, :dim] - R64).max()),
               "det_R_minus_1": float(np.linalg.det(
                   kh[:dim, :dim].astype(np.float64)) - 1.0)}
        emit(rec)
        check(err == 0.0, f"kabsch {kind}: kernel differs from its plain "
                          f"version by {err} (the same operations)")
        check(rec["R_max_abs_diff_svd_float64"] < 1e-5
              and abs(rec["det_R_minus_1"]) < 1e-5,
              f"kabsch {kind}: R off the float64 SVD's: {rec}")
        if kind == "conditioned":
            timed = (Hc, mpc, mqc)

    def library():
        U, _, Vt = torch.linalg.svd(timed[0])
        return torch.linalg.det(Vt.T @ U.T)
    ms = time_cuda(lambda: kabsch(*timed))
    plain_ms = time_cuda(lambda: kabsch_plain(*timed), reps=3, warmup=1)
    library_ms = time_cuda(library)
    kabsch.launches = before
    bytes_moved = (9 + 3 + 3 + 16) * 4
    ops_ms = kabsch_ops(3) / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    emit({"phase": "kernel_case", "case": "kabsch_timed", "kernel": "kabsch",
          "kernel_ms": ms, "plain_ms": plain_ms,
          "library_ms_svd_det": library_ms, "f32_operations": kabsch_ops(3),
          "bytes": bytes_moved, "bound_ops_ms": ops_ms,
          "bound_bytes_ms": bytes_ms})
    return {"name": "kabsch", "route": "cuda",
            "source": "norlab_icp_mapper_tpu_torch/csrc/kabsch.cu",
            "replaces": "icp/engine.py:554", "launches": 0,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


PHILOX_INT_OPS_PER_BLOCK = 10 * 10 + 12  # rounds x (2 hi, 2 lo, 4 xor,
# 2 key adds) + 4 shifts, 4 conversions, 4 scalings


def philox_case():
    """``csrc/philox.cu`` against ``philox_plain`` bit for bit, at the
    reading's capacity and at a ragged length, on the card and against the
    CPU's plain version; timed beside the plain version and ``torch.rand``
    on a CUDA generator (the library's uniforms, which are other numbers).
    Bound: the floats written against the integer operations at the f32
    rate (the guide's table gives no int32 rate)."""
    from norlab_icp_mapper_tpu_torch.ops.philox import (philox_plain,
                                                        philox_uniform)
    dev = torch.device("cuda")
    before = philox_uniform.launches
    solve = torch.tensor(17, dtype=torch.int64, device=dev)
    it = torch.tensor(9, dtype=torch.int32, device=dev)
    worst = 0.0
    for n in (SCAN_CAPACITY, SCAN_CAPACITY - 5, 1001):
        k = philox_uniform(1234, solve, it, 0, n)
        p = philox_plain(1234, solve, it, 0, n)
        c = philox_plain(1234, solve.cpu(), it.cpu(), 0, n)
        err = float((k - p).abs().max())
        worst = max(worst, err)
        mean = float(k.mean())
        rec = {"phase": "kernel_case", "case": f"philox_n{n}",
               "kernel": "philox", "bit_identical_plain": bool(
                   torch.equal(k, p)),
               "bit_identical_cpu": bool(torch.equal(k.cpu(), c)),
               "mean": mean, "min": float(k.min()), "max": float(k.max())}
        emit(rec)
        check(rec["bit_identical_plain"] and rec["bit_identical_cpu"],
              f"philox n={n}: kernel differs from its plain version: {rec}")
        check(abs(mean - 0.5) < 6 * (1 / 12 / n) ** 0.5,
              f"philox n={n}: mean {mean} of uniforms")
    n = SCAN_CAPACITY
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    ms = time_cuda(lambda: philox_uniform(1234, solve, it, 0, n))
    plain_ms = time_cuda(lambda: philox_plain(1234, solve, it, 0, n))
    library_ms = time_cuda(lambda: torch.rand(n, device=dev, generator=gen))
    philox_uniform.launches = before
    blocks = (n + 3) // 4
    bytes_moved = n * 4 + 8 + 4
    ops_ms = blocks * PHILOX_INT_OPS_PER_BLOCK / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    emit({"phase": "kernel_case", "case": "philox_timed", "kernel": "philox",
          "n": n, "kernel_ms": ms, "plain_ms": plain_ms,
          "library_ms_torch_rand": library_ms, "bound_ops_ms": ops_ms,
          "bound_bytes_ms": bytes_ms})
    return {"name": "philox", "route": "cuda",
            "source": "norlab_icp_mapper_tpu_torch/csrc/philox.cu",
            "replaces": "icp/engine.py:585", "launches": 0,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": library_ms}


KEEP_LENGTHS = (1, 3, 5, SCAN_CAPACITY - 1, SCAN_CAPACITY)
KEEP_PROBS = (0.9, 0.0, 1.0)


def philox_keep_case():
    """``philox_keep_kernel`` against ``philox_keep_plain`` bit for bit on
    the card (and against the CPU's plain version): at the reading's
    capacity and ragged lengths, ``rows`` a random permutation and None,
    ``prob`` 0.9, 0 and 1, a mask with holes.  Timed at the solve's shape
    (49,152 rows, a permutation, prob 0.9) beside the plain version; no
    library call computes the keyed function.  Bound: the bytes the
    function moves (``rows``, ``mask`` read, ``keep`` written) against the
    integer operations of one Philox block per four rows at the f32 rate;
    its device time inside a solve graph's replay comes from the profile
    phase (``p2plane_step``)."""
    from norlab_icp_mapper_tpu_torch.ops.philox import (philox_keep,
                                                        philox_keep_plain)
    dev = torch.device("cuda")
    before = philox_keep.launches
    solve = torch.tensor(17, dtype=torch.int64, device=dev)
    it = torch.tensor(9, dtype=torch.int32, device=dev)
    gen = torch.Generator().manual_seed(12)
    cases = []
    for n in KEEP_LENGTHS:
        mask = torch.rand(n, generator=gen) > 0.15
        perm = torch.randperm(n, generator=gen)
        for rows in (perm, None):
            for prob in KEEP_PROBS:
                kd = philox_keep(1234, solve, it, 1, prob, mask.to(dev),
                                 None if rows is None else rows.to(dev))
                pd = philox_keep_plain(1234, solve, it, 1, prob,
                                       mask.to(dev),
                                       None if rows is None else rows.to(dev))
                pc = philox_keep_plain(1234, solve.cpu(), it.cpu(), 1, prob,
                                       mask, rows)
                cases.append({"n": n, "rows": "none" if rows is None
                              else "permutation", "prob": prob,
                              "kept": int(kd.sum()), "valid": int(mask.sum()),
                              "plain": bool(torch.equal(kd, pd)),
                              "cpu": bool(torch.equal(kd.cpu(), pc)),
                              "err": int((kd != pd).any())})
    bad = [c for c in cases if not (c["plain"] and c["cpu"])]
    emit({"phase": "kernel_case", "case": "philox_keep", "kernel":
          "philox_keep", "cases": len(cases), "differing": bad,
          "kept_share_n49152": [c["kept"] / max(c["valid"], 1)
                                for c in cases if c["n"] == SCAN_CAPACITY]})
    check(not bad, f"philox_keep: kernel differs from its plain version: "
                   f"{bad}")
    check(all(c["kept"] == 0 for c in cases if c["prob"] == 0.0)
          and all(c["kept"] == c["valid"] for c in cases
                  if c["prob"] == 1.0),
          "philox_keep: prob 0 kept a row or prob 1 dropped one")
    n = SCAN_CAPACITY
    mask = (torch.rand(n, generator=gen) > 0.15).to(dev)
    rows = torch.randperm(n, generator=gen).to(dev)

    def kernel():
        return philox_keep(1234, solve, it, 1, 0.9, mask, rows)
    ms = time_cuda(kernel)
    plain_ms = time_cuda(lambda: philox_keep_plain(1234, solve, it, 1, 0.9,
                                                   mask, rows))
    PROFILE_JOBS.append(("device_ms", "philox_keep", kernel,
                         "philox_keep_kernel"))
    philox_keep.launches = before
    bytes_moved = n * (8 + 1 + 1) + 8 + 4
    ops_ms = (n + 3) // 4 * PHILOX_INT_OPS_PER_BLOCK / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    emit({"phase": "kernel_case", "case": "philox_keep_timed",
          "kernel": "philox_keep", "n": n, "kernel_ms": ms,
          "plain_ms": plain_ms, "bytes": bytes_moved,
          "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms})
    return {"name": "philox_keep", "route": "cuda",
            "source": "norlab_icp_mapper_tpu_torch/csrc/philox.cu",
            "replaces": "icp/engine.py:585, filters/core.py:204",
            "launches": 0,
            "max_abs_err": float(max(c["err"] for c in cases)),
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


COMMIT_MAX_ITER = 40
# (name, it, done, step, differential checker, bound checker, identity,
#  the done flag the commit must leave; None: inactive, every bit kept)
COMMIT_STATES = (
    ("inactive_done", 5, True, "large", (1e-3, 1e-3, 4), (0.8, 1.0), False,
     None),
    ("inactive_counter", COMMIT_MAX_ITER, False, "large", (1e-3, 1e-3, 4),
     None, False, None),
    ("diff_warming", 1, False, "small", (1e-3, 1e-3, 4), None, False, False),
    ("diff_trips", 6, False, "small", (1e-3, 1e-3, 4), None, False, True),
    ("diff_holds", 6, False, "large", (1e-3, 1e-3, 4), None, False, False),
    ("bound_trips", 2, False, "large", None, (0.5, 0.05), False, True),
    ("bound_holds", 2, False, "large", (1e-3, 1e-3, 4), (1.0, 10.0), False,
     False),
    ("identity", 0, False, "identity", None, None, True, True),
)


def rigid(rng, angle, shift, dim):
    """A seeded rigid transform ``[D+1, D+1]`` in float32."""
    T = np.eye(dim + 1)
    if dim == 2:
        T[:2, :2] = [[np.cos(angle), -np.sin(angle)],
                     [np.sin(angle), np.cos(angle)]]
    else:
        a = rng.normal(size=3)
        a /= np.linalg.norm(a)
        K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
        T[:3, :3] = np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K
    T[:dim, dim] = rng.normal(size=dim) * shift
    return T.astype(np.float32)


def commit_state(rng, dim, it, done, step, diff, identity, fresh, dev):
    """The loop state and one iteration's results as ``loop_commit`` takes
    them, on ``dev``: the kwargs of one call."""
    rows = diff[2] if diff else 1
    hist = np.full((rows, 2), np.inf, np.float32)
    hist[:min(it, rows)] = rng.uniform(0, 4e-4, size=(min(it, rows), 2))
    dT = {"identity": np.eye(dim + 1, dtype=np.float32),
          "small": rigid(rng, 2e-4, 1e-4, dim),
          "large": rigid(rng, 0.05, 0.05, dim)}[step]
    t = lambda x, dt: torch.tensor(x, dtype=dt, device=dev)  # noqa: E731
    kw = dict(dT=torch.from_numpy(dT).to(dev),
              T=torch.from_numpy(rigid(rng, 0.3, 0.3, dim)).to(dev),
              it=t(it, torch.int32), done=t(done, torch.bool),
              hist=torch.from_numpy(hist).to(dev),
              overlap_new=t(0.8125, torch.float32),
              overlap=t(0.25, torch.float32))
    if not identity:
        kw.update(rms_new=t(0.0625, torch.float32), rms=t(0.5, torch.float32))
    if fresh:
        kw.update(overflow_new=t(2, torch.int64), overflow=t(3, torch.int64))
    return kw


def _commit(fn, kw, max_iter=COMMIT_MAX_ITER, **cfg):
    args = [kw[k] for k in ("dT", "T", "it", "done", "hist", "overlap_new",
                            "overlap")]
    fn(*args, rms_new=kw.get("rms_new"), rms=kw.get("rms"),
       overflow_new=kw.get("overflow_new"), overflow=kw.get("overflow"),
       max_iter=max_iter, **cfg)


def commit_bytes(dim, rows) -> int:
    """Bytes one commit must move: dT, T, it, done, the window, overlap,
    rms and overflow (new and state) read once; T, it, done, the window,
    overlap, rms and overflow written once."""
    mat = (dim + 1) ** 2 * 4
    read = 2 * mat + 4 + 1 + rows * 8 + 2 * 4 + 2 * 4 + 2 * 8
    write = mat + 4 + 1 + rows * 8 + 4 + 4 + 8
    return read + write


def commit_ops(dim, rows) -> int:
    """f32 operations of one commit with both checkers: the product
    (H^2 (H mul + H-1 add)), two norms (D mul, D-1 add, sqrt), two angles
    (3-D: 2 add, sub, div, 2 compares, acos counted as 20), the window
    means (2 (rows-1) add, 2 div) and six compares."""
    h = dim + 1
    angle = 26 if dim == 3 else 21  # atan2 counted as 20
    return h * h * (2 * h - 1) + 2 * (2 * dim) + 2 * angle \
        + 2 * (rows - 1) + 2 + 6


def loop_commit_case(rng):
    """``loop_commit`` (``csrc/graph_loop.cu``) against
    ``loop_commit_plain`` on the same card tensors, bit for bit, over states
    that cover an active and an inactive loop, the differential checker
    warming, tripping and holding, the bound checker tripping and holding,
    the identity minimizer, with and without a matcher pass's overflow, in
    2-D and 3-D; each against the CPU's plain version too (acos / atan2 of
    another library: reported).  Then the launch timed beside the plain
    version; the device time inside a solve graph's replay comes from the
    profile phase."""
    from norlab_icp_mapper_tpu_torch.ops.graph_loop import (
        loop_commit, loop_commit_plain)
    dev = torch.device("cuda")
    before = loop_commit.launches
    worst_cpu, n_states = 0.0, 0
    for dim in (2, 3):
        for (name, it, done, step, diff, bound, identity,
             want_done) in COMMIT_STATES:
            for fresh in (True, False):
                seed = int(rng.integers(2**31))
                states = [commit_state(np.random.default_rng(seed), dim, it,
                                       done, step, diff, identity, fresh, d)
                          for d in (dev, dev, "cpu")]
                orig = {k: v.clone() for k, v in states[0].items()}
                cfg = dict(identity=identity, diff_checker=diff,
                           bound_checker=bound)
                _commit(loop_commit, states[0], **cfg)
                _commit(loop_commit_plain, states[1], **cfg)
                _commit(loop_commit_plain, states[2], **cfg)
                torch.cuda.synchronize()
                k, p, c = states
                same = all(torch.equal(k[key], p[key]) for key in k)
                cpu = max(float((k[key].cpu().double()
                                 - c[key].double()).abs().nan_to_num(
                                     0.0).max()) for key in k)
                worst_cpu = max(worst_cpu, cpu)
                kept = all(torch.equal(k[key], orig[key]) for key in k)
                rec = {"phase": "kernel_case",
                       "case": f"loop_commit_{name}_D{dim}"
                               f"{'' if fresh else '_held_pairs'}",
                       "kernel": "loop_commit", "bit_identical_plain": same,
                       "max_abs_diff_cpu_plain": cpu,
                       "done": bool(k["done"]), "it": int(k["it"]),
                       "state_kept": kept}
                emit(rec)
                n_states += 1
                check(same, f"loop_commit {name} D={dim}: kernel differs "
                            f"from its plain version: {rec}")
                if want_done is None:
                    check(kept, f"loop_commit {name} D={dim}: an inactive "
                                f"commit changed the state: {rec}")
                else:
                    check(rec["done"] == want_done
                          and rec["it"] == it + 1,
                          f"loop_commit {name} D={dim}: done / it: {rec}")
                check(cpu < 1e-5, f"loop_commit {name} D={dim}: the card "
                                  f"and the CPU differ by {cpu}")
    # timed: 3-D, both checkers, never tripping (an angle is at most pi),
    # a matcher pass, a counter that does not run out: every commit active
    kw = commit_state(np.random.default_rng(1), 3, 6, False, "small",
                      (0.0, 0.0, 4), False, True, dev)
    cfg = dict(diff_checker=(0.0, 0.0, 4), bound_checker=(3.2, 1e9),
               max_iter=2**30)
    ms = time_cuda(lambda: _commit(loop_commit, kw, **cfg))
    plain_ms = time_cuda(lambda: _commit(loop_commit_plain, kw, **cfg),
                         reps=7, warmup=1)
    loop_commit.launches = before
    bytes_moved = commit_bytes(3, 4)
    ops = commit_ops(3, 4)
    ops_ms = ops / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    emit({"phase": "kernel_case", "case": "loop_commit_timed",
          "kernel": "loop_commit", "states_held": n_states,
          "kernel_ms": ms, "plain_ms": plain_ms, "bytes": bytes_moved,
          "f32_operations": ops, "bound_ops_ms": ops_ms,
          "bound_bytes_ms": bytes_ms})
    return {"name": "loop_commit", "route": "cuda",
            "source": "norlab_icp_mapper_tpu_torch/csrc/graph_loop.cu",
            "replaces": "icp/engine.py:600", "launches": 0,
            "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


def p2p_pairs(rng, n, k, dim, dev):
    """Seeded weighted pairs at the hall's coordinates (the reading 20-60 m
    from the origin), as the point-to-point minimizer gets them: ``k``
    matches a row, a tenth of the rows masked (weight 0, matched to the
    map's first point), trimmed pairs at weight 0."""
    scale = np.array([12.0, 6.0, 1.5][:dim])
    p = rng.normal(size=(n, dim)) * scale + np.array([40.0, 15.0, 2.0][:dim])
    R = rigid(rng, 0.02, 0.0, dim)[:dim, :dim].astype(np.float64)
    q = (p @ R.T + np.array([0.05, -0.03, 0.02][:dim]))[:, None, :] \
        + rng.normal(size=(n, k, dim)) * 0.01
    w = (rng.random((n, k)) < 0.9).astype(np.float64)
    masked = rng.random(n) < 0.1
    w[masked] = 0.0
    q[masked] = q[0, 0]
    return [torch.from_numpy(x.astype(np.float32)).to(dev) for x in (p, q, w)]


def p2p_bytes(n, k, dim) -> int:
    """The pairs read once, the moments, ``dT`` and the rms written once."""
    from norlab_icp_mapper_tpu_torch.ops.kabsch import n_moments
    return n * (dim + k * dim + k) * 4 + n_moments(dim) * 8 \
        + (dim + 1) ** 2 * 4 + 4


def p2p_f64_ops(n, k, dim) -> int:
    """float64 operations of the moments: per pair w p (D), w q (D),
    (w p) q^T (D^2), the sums (1 + 2D + D^2 + 1), p - q (D), |.|^2 (2D - 1),
    w |.|^2 (1)."""
    per_pair = dim + dim + dim * dim + (2 + 2 * dim + dim * dim) + dim \
        + (2 * dim - 1) + 1
    return n * k * per_pair


def p2p_step_case(rng):
    """``p2p_step`` (``csrc/kabsch.cu``) at the point-to-point drive's shape
    (49,152 rows, k = 1) and at k = 3 (3-D), and a 2-D case: the kernel's
    float64 moments within 1e-12 of the plain version's, relative to the
    sums of the terms' absolute values (only the order of the sums
    differs); two launches' moments bit for bit (no atomics); the solve
    stage bit for bit given the same moments (the fused launch's own, and
    the solve-from-moments kernel); ``dT`` within 1e-6 of the plain
    version's; R within 1e-5 of a float64 SVD of the float64 moments.
    Then the launch timed beside the plain version (no single PyTorch call
    computes the function); the device time inside a solve graph's replay
    comes from the profile phase."""
    from norlab_icp_mapper_tpu_torch.ops import kabsch as K
    dev = torch.device("cuda")
    before = (K.p2p_step.launches, K.kabsch.launches)
    worst, timed = 0.0, None
    for n, k, dim in ((SCAN_CAPACITY, 1, 3), (SCAN_CAPACITY, 3, 3),
                      (SCAN_CAPACITY, 1, 2), (1001, 3, 3)):
        p, q, w = p2p_pairs(rng, n, k, dim, dev)
        m_k, dT_k, rms_k = K._p2p_kernel(p, q, w, solve=True)
        m_k2 = K.p2p_moments(p, q, w)
        m_p = K.p2p_moments_plain(p, q, w)
        dT_p, rms_p = K.p2p_step_plain(p, q, w)
        dT_s, rms_s = K.solve_moments_plain(m_k, dim)
        dT_m, rms_m = K.kabsch_from_moments(m_k, dim)
        # the scale of the rounding: the sums of the terms' absolute values
        size = K.p2p_moments_plain(p.abs(), q.abs(), w)
        size[-1] = m_p[-1]
        torch.cuda.synchronize()
        rel = float(((m_k - m_p).abs() / size.clamp(min=1e-300)).max())
        err = float((dT_k - dT_p).abs().max())
        worst = max(worst, err)
        m64 = m_p.cpu().numpy()
        wsum = max(m64[0], 1e-9)
        sp, sq = m64[1:1 + dim], m64[1 + dim:1 + 2 * dim]
        H = m64[1 + 2 * dim:1 + 2 * dim + dim * dim].reshape(dim, dim) \
            - np.outer(sp, sq) / wsum
        U, _, Vt = np.linalg.svd(H)
        D = np.eye(dim)
        D[-1, -1] = np.linalg.det(Vt.T @ U.T)
        R64 = Vt.T @ D @ U.T
        rec = {"phase": "kernel_case", "case": f"p2p_step_n{n}_k{k}_D{dim}",
               "kernel": "p2p_step", "moments_max_rel_err": rel,
               "moments_deterministic": bool(torch.equal(m_k, m_k2)),
               "solve_bit_identical_plain": bool(
                   torch.equal(dT_k, dT_s) and torch.equal(rms_k, rms_s)),
               "solve_from_moments_bit_identical_plain": bool(
                   torch.equal(dT_m, dT_s) and torch.equal(rms_m, rms_s)),
               "dT_max_abs_err_plain": err,
               "rms_abs_err_plain": float((rms_k - rms_p).abs()),
               "R_max_abs_diff_svd_float64": float(np.abs(
                   dT_k[:dim, :dim].cpu().numpy() - R64).max())}
        emit(rec)
        check(rel <= 1e-12 and rec["moments_deterministic"],
              f"p2p_step: moments off the plain version's: {rec}")
        check(rec["solve_bit_identical_plain"]
              and rec["solve_from_moments_bit_identical_plain"],
              f"p2p_step: the solve differs from its plain version: {rec}")
        check(err <= 1e-6 and rec["rms_abs_err_plain"] <= 1e-6,
              f"p2p_step: dT off the plain version's: {rec}")
        check(rec["R_max_abs_diff_svd_float64"] < 1e-5,
              f"p2p_step: R off the float64 SVD's: {rec}")
        if timed is None:
            timed = (n, k, dim, (p, q, w))
    n, k, dim, args = timed
    ms = time_cuda(lambda: K.p2p_step(*args))
    plain_ms = time_cuda(lambda: K.p2p_step_plain(*args), reps=7, warmup=1)
    K.p2p_step.launches, K.kabsch.launches = before
    bytes_moved = p2p_bytes(n, k, dim)
    ops = p2p_f64_ops(n, k, dim)
    ops_ms = ops / PEAK_F64_FLOPS * 1e3 + kabsch_ops(dim) / PEAK_F32_FLOPS \
        * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    emit({"phase": "kernel_case", "case": "p2p_step_timed",
          "kernel": "p2p_step", "n": n, "k": k, "dim": dim,
          "kernel_ms": ms, "plain_ms": plain_ms, "bytes": bytes_moved,
          "f64_operations": ops, "bound_ops_ms": ops_ms,
          "bound_bytes_ms": bytes_ms})
    return {"name": "p2p_step", "route": "cuda",
            "source": "norlab_icp_mapper_tpu_torch/csrc/kabsch.cu",
            "replaces": "icp/engine.py:548", "launches": 0,
            "max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


def while_node_case():
    """The WHILE node of ``csrc/graph_loop.cu`` around a body of one
    ``loop_commit`` (the identity increment, no checker: the counter runs
    out) that sets the node's condition, 1,000 iterations, against the same
    body under a Python loop that reads the condition before each iteration
    (what the CPU path does).  Its tensors are the main path's: a 0-d int32
    counter, a 0-d bool stop flag, the 4x4 transform, the window, the
    overlap."""
    from norlab_icp_mapper_tpu_torch.ops import graph_loop
    dev = torch.device("cuda")
    n_iter = 1000
    before = graph_loop.loop_commit.launches
    it = torch.zeros((), dtype=torch.int32, device=dev)
    stop = torch.zeros((), dtype=torch.bool, device=dev)
    eye = torch.eye(4, device=dev)
    T = eye.clone()
    hist = torch.zeros((1, 2), device=dev)
    ov_new = torch.ones((), device=dev)
    ov = torch.zeros((), device=dev)

    def commit(body=None):
        graph_loop.loop_commit(eye, T, it, stop, hist, ov_new, ov,
                               max_iter=n_iter, body=body)
    commit()  # the library is loaded before the capture
    body_stream, pool = torch.cuda.Stream(), torch.cuda.MemPool()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(torch.cuda.Stream()):
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            it.zero_()
            with graph_loop.while_node(it, stop, n_iter, body_stream,
                                       pool) as body:
                commit(body)
        finally:
            graph.capture_end()

    def plain():
        it.zero_()
        while not bool(stop) and int(it) < n_iter:
            commit()

    # graph.replay(), not graph_loop.replay(): these launches do not count
    graph.replay()
    got = int(it)
    plain()
    want = int(it)
    ms = time_cuda(graph.replay)
    plain_ms = time_cuda(plain, reps=3, warmup=1)
    graph_loop.loop_commit.launches = before
    # per iteration the commit reads dT, T, it, stop, the window and both
    # overlaps and writes T, it, stop, the window and the overlap
    bytes_moved = n_iter * ((2 * 64 + 4 + 1 + 8 + 8) + (64 + 4 + 1 + 8 + 4))
    bound_ms = bytes_moved / PEAK_BYTES * 1e3
    emit({"phase": "kernel_case", "case": "while_node_1000",
          "kernel": "graph_while", "body": "one loop_commit",
          "iterations_node": got,
          "iterations_plain": want, "kernel_ms": ms,
          "us_per_iteration": ms * 1e3 / n_iter, "plain_ms": plain_ms,
          "bound_bytes_ms": bound_ms,
          "bound_arithmetic": f"{bytes_moved} bytes / 3.35 TB/s"})
    check(got == want == n_iter,
          f"while node: {got} iterations, the plain loop {want}")
    graph.reset()
    return {
        "name": "graph_while", "route": "cuda",
        "source": "norlab_icp_mapper_tpu_torch/csrc/graph_loop.cu",
        "replaces": "icp/engine.py:631", "launches": 0,
        "max_abs_err": float(abs(got - want)), "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
        "library_ms": None,
    }


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
    # the same cloud with twins, windows of one chunk (tiles of 256 queries)
    # and of two: exact, ties across the chunk border included
    twin_pos = mp.positions.clone()
    twin_pos[1::2] = twin_pos[0:-1:2]
    sweep_case("exact_twins_k3_one_chunk", sc.positions, sc.mask, twin_pos,
               mp.mask, 3, 2.0, 256, 2048, 112, exact=True)
    sweep_case("exact_twins_k3_two_chunks", sc.positions, sc.mask, twin_pos,
               mp.mask, 3, 2.0, 1024, 4096, 112, exact=True)
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
             2048, on_path=False, rng=rng, exact=True)
    # the same cloud 500 m from the origin on every axis
    far = mp.positions + torch.tensor([500.0, -500.0, 500.0], device=dev)
    pca_case("exact_surface_normals_offset_500m", far, mp.mask, 1.0, 1024,
             2048, on_path=False, rng=rng, exact=True)
    pca_two_clouds_case("sparse_scan_against_map", sc.positions, sc.mask,
                        mp.positions, mp.mask, 1.0, 1024, 2048)


def split_phases(totals, label):
    """``PhaseTimer.totals()`` as two records: the spans' milliseconds
    under ``phase_ms_<label>`` and the counters (``count.*``) under
    ``phase_counts_<label>``."""
    return {f"phase_ms_{label}": {k: round(v, 2) for k, v in totals.items()
                                  if not k.startswith("count.")},
            f"phase_counts_{label}": {k: v for k, v in totals.items()
                                      if k.startswith("count.")}}


def reset_counts():
    from norlab_icp_mapper_tpu_torch.ops import graph_loop
    from norlab_icp_mapper_tpu_torch.ops.nn import knn
    from norlab_icp_mapper_tpu_torch.ops.nn_sweep import sweep_knn
    from norlab_icp_mapper_tpu_torch.ops.pca import radius_pca
    from norlab_icp_mapper_tpu_torch.ops.eigen import sym_eig3_smallest
    from norlab_icp_mapper_tpu_torch.ops.kabsch import kabsch, p2p_step
    from norlab_icp_mapper_tpu_torch.ops.philox import (philox_keep,
                                                        philox_uniform)
    from norlab_icp_mapper_tpu_torch.ops.nn_grid import knn_grid
    sweep_knn.launches = 0
    sweep_knn.launches_by_shape = {}
    knn_grid.launches = 0
    knn_grid.launches_by_shape = {}
    radius_pca.launches = 0
    sym_eig3_smallest.launches = 0
    knn.launches = 0
    knn.launches_by_shape = {}
    graph_loop.replay.launches = 0
    for f in (kabsch, p2p_step, philox_uniform, philox_keep,
              graph_loop.loop_commit):
        f.launches = 0
        f.launches_by_shape = {}


def read_counts():
    from norlab_icp_mapper_tpu_torch.ops import graph_loop
    from norlab_icp_mapper_tpu_torch.ops.nn import knn
    from norlab_icp_mapper_tpu_torch.ops.nn_sweep import sweep_knn
    from norlab_icp_mapper_tpu_torch.ops.pca import radius_pca
    from norlab_icp_mapper_tpu_torch.ops.eigen import sym_eig3_smallest
    from norlab_icp_mapper_tpu_torch.ops.kabsch import kabsch, p2p_step
    from norlab_icp_mapper_tpu_torch.ops.philox import (philox_keep,
                                                        philox_uniform)
    out = {f"sweep_knn[D={d},k={k}]": v
           for (d, k), v in sweep_knn.launches_by_shape.items()}
    out.update({f"knn_brute[D={d},k={k}]": v
                for (d, k), v in knn.launches_by_shape.items()})
    from norlab_icp_mapper_tpu_torch.ops.nn_grid import knn_grid
    out.update({f"knn_grid[D={d}]": v
                for d, v in knn_grid.launches_by_shape.items()})
    out["radius_pca[D=3]"] = radius_pca.launches
    out["sym_eig[D=3]"] = sym_eig3_smallest.launches
    out["sweep_knn"] = sweep_knn.launches
    out["knn_brute"] = knn.launches
    out["graph_while"] = graph_loop.replay.launches  # solve graph replays
    out["kabsch"] = kabsch.launches
    out["p2p_step"] = p2p_step.launches
    out["philox"] = philox_uniform.launches
    out["philox_keep"] = philox_keep.launches
    out["loop_commit"] = graph_loop.loop_commit.launches
    return out


@contextlib.contextmanager
def no_sync(mapper, tally, on: bool):
    """Run the block under ``torch.cuda.set_sync_debug_mode("error")``: any
    call that makes the host wait for the card raises.  A scan that applies
    deferred rolling-window events, or replays a merge that filled the map
    buffer, waits by design (so does the JAX package's, ``mapper.py:363-369``):
    it runs under ``"warn"`` and its synchronising calls are counted in
    ``tally``, as are the mapper's own counted waits (``Mapper.waits``)."""
    if not on:
        yield
        return
    import warnings
    window = bool(mapper._pending_window) \
        or mapper._overflow_remerge is not None
    before = dict(mapper.waits)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn" if window else "error")
        try:
            yield
        finally:
            torch.cuda.set_sync_debug_mode(0)
    tally["scans_checked"] += 1
    if window:
        tally["waiting_scans"] += 1
        tally["waiting_scan_syncs"] += sum(
            "synchroniz" in str(w.message) for w in caught)
    for k, v in mapper.waits.items():
        tally[f"waits_{k}"] += v - before[k]


def drive(config_name, scans, priors, phase, strict=False, online=False,
          config=None, setup=None):
    """Feed the sequence through a fresh Mapper, draining after each scan
    (step-locked); returns the mapper and the per-scan records.  ``strict``
    runs the steady-state scans' filters and step under ``no_sync``.
    ``config`` (a dict) replaces the file ``config_name`` names, which
    then only labels the record; ``setup(mapper)`` runs before the first
    scan."""
    import collections
    import norlab_icp_mapper_tpu_torch as nt
    mapper = nt.Mapper(
        config if config is not None
        else os.path.join(HERE, "examples", config_name),
        is_3d=True, device="cuda", seed=0, is_online=online)
    mapper.timer.enabled = True
    if setup is not None:
        setup(mapper)
    reset_counts()
    per_scan, counts, valid, iters = [], [], [], []
    syncs = collections.Counter()
    for i, (scan, prior) in enumerate(zip(scans, priors)):
        mapper.drain()
        t0 = time.time()
        batch = nt.PointBatch.from_numpy(scan, capacity=SCAN_CAPACITY,
                                         device="cuda")
        with no_sync(mapper, syncs, strict and i >= 2):
            filtered = mapper.apply_input_filters(batch)
            mapper.process_input(filtered, prior, int(i * 1e8))
        mapper.drain()
        per_scan.append((time.time() - t0) * 1e3)
        last = (filtered, prior)
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
        "steady_ms_median": statistics.median(steady),
        "scans_per_s": 1e3 / statistics.mean(steady),
        "map_counts": counts, "final_map_count": counts[-1],
        "map_capacity": mapper.map.local.capacity,
        "icp_iterations": iters, "launches": launches,
        **split_phases(phases, "steady_total"),
        **split_phases(warmup, "first_two_scans"),
        "last_scan_overflow_tiles": overflow,
        "graph_captures": mapper.icp.graph_captures,
        "mapper_waits": dict(mapper.waits),
    }
    if strict:
        rec["sync_check"] = dict(syncs)
    mapper.last_scan = last
    return mapper, rec


# The solve per ICP iteration before the commit was one kernel and the
# point-to-point minimizer one launch (NVIDIA H100 80GB HBM3, 700 W; the
# solve phase's CUDA events over the steady scans, and torch.profiler's
# device launches over one steady scan or one sharded solve graph),
# printed beside this run's
EAGER_COMMIT_SOLVE = {
    "p2plane": {"solve_ms_per_iteration": [0.843, 0.880],
                "device_launches_per_steady_scan": 3824},
    "p2point": {"solve_ms_per_iteration": [0.854, 0.933]},
    "sharded": {"solve_graph_ms": 18.91,
                "device_launches_per_steady_scan": 7125},
}

# Final map sizes and iterations per scan on this sequence (seed 0) before
# the solve became a CUDA graph and the loop pipelined (the eager loop);
# the gates hold the new loop to them.
IDENTITY_MAP_POINTS = 87_342
P2PLANE_MAP_POINTS = 83_552
P2PLANE_ITERATIONS = 20.24
DEFAULT_MAP_POINTS = 101_404


def hold_graph_solve(mapper, phase):
    """The solve of the phase's last scan, replayed from the graph the
    phase captured, against the same body under the Python loop that reads
    ``done`` before each iteration, on the same card tensors (and, with
    step filters, the same keyed draws): T bit for bit and the same
    iterations (the masked iterations after the stop change nothing)."""
    from norlab_icp_mapper_tpu_torch import se3
    from norlab_icp_mapper_tpu_torch.icp import engine
    icp = mapper.icp
    filtered, prior = mapper.last_scan
    reading = se3.apply(torch.as_tensor(prior, device="cuda"), filtered)
    if len(icp.reading_filters):
        reading = icp.reading_filters._apply_impl(reading, mapper.draws)
    ref = icp._ref
    args = (reading.positions, reading.mask, ref.positions,
            icp.check_reference(ref), ref.mask, icp._ref_pack)
    captures = icp.graph_captures
    # step filters draw keyed by the mapper's seed and the solve index the
    # graph's replay drew with; the loop is handed the same
    step = icp.reading_step_filters if len(icp.reading_step_filters) else None
    g = icp.solve(*args, draws=mapper.draws)
    loop = engine._icp_solve(*args, step_filters=step, draws=mapper.draws,
                             solve_index=icp.last_solve_index,
                             **icp.solve_config())
    it_g, it_l = int(g.iterations), int(loop[2])
    same = bool(torch.equal(g.correction, loop[0]))
    emit({"phase": f"{phase}_graph_vs_loop", "iterations_graph": it_g,
          "iterations_loop": it_l, "T_bit_identical": same,
          "T_max_abs_diff": float((g.correction - loop[0]).abs().max()),
          "overlap_bit_identical": bool(torch.equal(g.overlap, loop[1])),
          "new_captures": icp.graph_captures - captures})
    check(icp.graph_captures == captures,
          f"{phase}: the check captured a new graph instead of replaying "
          "the phase's")
    check(same and it_g == it_l,
          f"{phase}: the graph solve differs from its body's Python loop "
          f"({it_g} against {it_l} iterations, T equal: {same})")
    # the solve graph's replay measured in the profile phase, beside one
    # body of the same loop run eagerly (its device launches)
    body = engine._Loop(*args, step_filters=step, draws=mapper.draws,
                        solve_index=torch.full(
                            (), icp.last_solve_index, dtype=torch.int64,
                            device="cuda"), **icp.solve_config())
    body.start()

    def recapture():
        for g in icp._graphs.values():
            g.close()
        icp._graphs.clear()
    PROFILE_JOBS.append(("solve", phase, (
        lambda: icp.solve(*args, draws=mapper.draws), body.body,
        body.body_len, None, recapture), None))
    return body


def hold_step_paths(phase, loop):
    """The step chain of the first matcher pass of a solve (``loop``
    started: T = I, ``it`` = 0) both ways on the card: the path the solve
    takes (a row-local chain in the solve's row order, handed the sort as
    ``rows``) against the permute path (the reading permuted back to its
    original order, mask and positions forward): bit for bit.  Their
    device launches are counted in the profile phase."""
    from norlab_icp_mapper_tpu_torch import se3
    p = se3.apply_points(loop.T, loop.read)
    pos_s, mask_s = loop._stepped(p, loop.mask)
    pos_p, mask_p = loop._stepped_permuted(p, loop.mask)
    rec = {"phase": f"{phase}_step_paths",
           "row_local": loop.step_filters.row_local,
           "sorted": loop.order is not None,
           "mask_bit_identical": bool(torch.equal(mask_s, mask_p)),
           "positions_bit_identical": bool(torch.equal(pos_s, pos_p)),
           "kept": int(mask_s.sum()), "valid": int(loop.mask.sum())}
    emit(rec)
    check(rec["mask_bit_identical"] and rec["positions_bit_identical"],
          f"{phase}: the solve's step chain differs from the permute path: "
          f"{rec}")
    check(0 < rec["kept"] < rec["valid"],
          f"{phase}: the step chain kept {rec['kept']} of {rec['valid']}")
    for path, fn in (("solve", loop._stepped),
                     ("permuted", loop._stepped_permuted)):
        PROFILE_JOBS.append(("launches", f"step_pass/{phase}/{path}",
                             lambda fn=fn: fn(p, loop.mask), None))


def queue_scan_launches(phase, config, scans, priors):
    """A fresh Mapper on ``config`` fed three scans now; the profile phase
    counts the device launches of its fifth (one steady scan, drained)."""
    import norlab_icp_mapper_tpu_torch as nt
    mm = nt.Mapper(config, is_3d=True, device="cuda", seed=0)
    it = iter(range(len(scans)))

    def feed():
        i = next(it)
        b = nt.PointBatch.from_numpy(scans[i], capacity=SCAN_CAPACITY,
                                     device="cuda")
        mm.process_input(mm.apply_input_filters(b), priors[i], int(i * 1e8))
        mm.drain()
    for _ in range(3):
        feed()
    PROFILE_JOBS.append(("launches", f"steady_scan/{phase}", feed, None))


def free_running(config, scans, priors, online=False):
    """The sequence through a fresh Mapper without a drain between scans
    (one after the last): what the pipelined loop is for.  Returns the
    mapper and ``free_running_scans_per_s`` over the steady-state scans;
    ``online`` also times ``get_pose()`` after each of them (it waits for
    that scan's solve, not for its merge)."""
    import norlab_icp_mapper_tpu_torch as nt
    path = None if config is None else (
        config if isinstance(config, dict)
        else os.path.join(HERE, "examples", config))
    mapper = nt.Mapper(path, is_3d=True, device="cuda", seed=0,
                       is_online=online)
    batches = [nt.PointBatch.from_numpy(s, capacity=SCAN_CAPACITY,
                                        device="cuda") for s in scans]
    waits = []

    def feed(i):
        filtered = mapper.apply_input_filters(batches[i])
        mapper.process_input(filtered, priors[i], int(i * 1e8))

    for i in range(2):
        feed(i)
    mapper.drain()
    t0 = time.time()
    for i in range(2, len(scans)):
        feed(i)
        if online:
            t1 = time.time()
            mapper.get_pose()
            waits.append((time.time() - t1) * 1e3)
    mapper.drain()
    rec = {"free_running_scans_per_s": (len(scans) - 2) / (time.time() - t0),
           "free_running_final_map_count": mapper.map.known_count(),
           "free_running_mapper_waits": dict(mapper.waits)}
    if online:
        rec["get_pose_wait_ms"] = [round(w, 3) for w in waits]
    return mapper, rec


def check_graph_launches(phase, launches, n_scans):
    """Every scan after the bootstrap one solved by one replay of a solve
    graph (its WHILE node ran the ICP loop)."""
    check(launches["graph_while"] == n_scans - 1,
          f"{phase}: {launches['graph_while']} solve graph replays for "
          f"{n_scans - 1} registered scans")
    check(launches["loop_commit"] >= n_scans - 1,
          f"{phase}: {launches['loop_commit']} iteration commits on the "
          f"card for {n_scans - 1} solves")


def check_sync(rec):
    """The steady-state scans' filters and step made no synchronising call
    (``no_sync`` raised otherwise) and waited only where the loop counts a
    wait: at ``PIPELINE_DEPTH`` and at scans that apply window events."""
    sc = rec["sync_check"]
    phase = rec["phase"]
    check(sc.get("scans_checked", 0) == rec["scans"] - 2,
          f"{phase}: {sc} (not every steady-state scan was checked)")
    check(sc.get("waits_capacity", 0) == 0
          and sc.get("waits_shrink", 0) == 0
          and sc.get("waits_merge_decision", 0) == 0,
          f"{phase}: the loop waited for the card outside the allowed "
          f"waits: {sc}")


def check_map_size(phase, n, expected):
    check(abs(n - expected) <= 0.01 * expected,
          f"{phase}: final map holds {n} points, not within 1 % of "
          f"{expected}")


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


def count_k1_launches(obj, method, tally, key):
    """Wrap ``obj.method`` so that the ``knn_brute`` launches at D=3, k=1
    made inside it are added to ``tally[key]``: the wrapper's counter is
    read before and after every call."""
    from norlab_icp_mapper_tpu_torch.ops.nn import knn
    inner = getattr(obj, method)

    def counted(*args, **kwargs):
        before = knn.launches_by_shape.get((3, 1), 0)
        out = inner(*args, **kwargs)
        tally[key] += knn.launches_by_shape.get((3, 1), 0) - before
        return out
    setattr(obj, method, counted)


def strict_solves(mapper, steady, tally):
    """Run every ICP solve of the steady scans (``steady[0]`` true) under
    ``torch.cuda.set_sync_debug_mode("warn")`` and count the synchronising
    calls it makes in ``tally``: ``solve_syncs`` for a solve that replayed a
    graph it had, ``capture_solve_syncs`` for one that captured a new graph
    (the map grew)."""
    import warnings
    icp = mapper.icp
    inner = icp.solve

    def checked(*args, **kwargs):
        if not steady[0]:
            return inner(*args, **kwargs)
        captures = icp.graph_captures
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = inner(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        n = sum("synchroniz" in str(w.message) for w in caught)
        kind = "capture_solve" if icp.graph_captures != captures else "solve"
        tally[f"{kind}s_checked"] += 1
        tally[f"{kind}_syncs"] += n
        return out
    icp.solve = checked


def drive_default(scans, priors, config=None, phase="default",
                  strict_solve=False):
    """``Mapper(config)`` on a path without a radius (matcher without
    maxDist, k-NN normals as reference filter, PointDistanceMapperModule),
    full width; ``None`` is the default config.  ``strict_solve`` counts the
    synchronising calls of the steady scans' solves (``strict_solves``)."""
    import collections
    import norlab_icp_mapper_tpu_torch as nt
    mapper = nt.Mapper(config, is_3d=True, device="cuda", seed=0)
    mapper.timer.enabled = True
    steady, syncs = [False], collections.Counter()
    if strict_solve:
        strict_solves(mapper, steady, syncs)
    reset_counts()
    # who launched the k = 1 searches: counter readings around the
    # PointDistance module and around the ICP solve
    check(mapper.map.modules[0].NAME == "PointDistanceMapperModule",
          f"{phase}: the mapper module is {mapper.map.modules[0].NAME}")
    k1_by = {"point_distance": 0, "matcher": 0}
    count_k1_launches(mapper.map.modules[0], "update_map", k1_by,
                      "point_distance")
    # the matcher's launches: counted in the solve by the Python loop, and
    # where a solve graph's replay is counted once its iterations are known
    # (at harvest on the fused path, in ``ICPEngine.__call__`` on the
    # stepwise one): ``GraphReplay.count``
    from norlab_icp_mapper_tpu_torch.icp import engine
    count_k1_launches(mapper.icp, "solve", k1_by, "matcher")
    replay_count = engine.GraphReplay.count
    holder = types.SimpleNamespace(count=replay_count)
    count_k1_launches(holder, "count", k1_by, "matcher")
    engine.GraphReplay.count = holder.count
    per_scan, counts, caps, valid, iters, merged = [], [], [], [], [], []
    last_merge = None
    warmup = {}
    for i, (scan, prior) in enumerate(zip(scans, priors)):
        mapper.drain()
        steady[0] = i >= 2
        t0 = time.time()
        batch = nt.PointBatch.from_numpy(scan, capacity=SCAN_CAPACITY,
                                         device="cuda")
        filtered = mapper.apply_input_filters(batch)
        before, stamp = mapper.map.local, mapper.last_time_map_was_updated
        mapper.process_input(filtered, prior, int(i * 1e8))
        mapper.drain()
        per_scan.append((time.time() - t0) * 1e3)
        did = mapper.last_time_map_was_updated != stamp
        merged.append(bool(did))
        if did and i > 0:
            last_merge = (i, before, filtered, mapper.get_pose().copy(),
                          counts[-1])
        counts.append(mapper.map.known_count())
        caps.append(mapper.map.local.capacity)
        valid.append(int(filtered.count()))
        iters.append(int(mapper.last_iterations))
        if i == 1:
            warmup = mapper.timer.totals()
    mapper.last_scan = (filtered, prior)
    engine.GraphReplay.count = replay_count
    launches = read_counts()
    launches["knn_brute[D=3,k=10,normals]"] = \
        launches.get("knn_brute[D=3,k=10]", 0)
    for who, n in k1_by.items():
        launches[f"knn_brute[D=3,k=1,{who}]"] = n
    phases = mapper.timer.totals()
    steady = per_scan[2:]
    rec = {
        "phase": phase, "config": config, "scans": len(scans),
        "valid_points_per_scan_min": min(valid),
        "per_scan_ms": [round(v, 2) for v in per_scan],
        "steady_ms_per_scan": statistics.mean(steady),
        "scans_per_s": 1e3 / statistics.mean(steady),
        "merged": merged, "map_counts": counts, "map_capacities": caps,
        "final_map_count": counts[-1], "map_capacity": caps[-1],
        "icp_iterations": iters, "launches": launches,
        **split_phases(phases, "steady_total"),
        **split_phases(warmup, "first_two_scans"),
        "graph_captures": mapper.icp.graph_captures,
        "mapper_waits": dict(mapper.waits),
    }
    if strict_solve:
        rec["solve_sync_check"] = dict(syncs)
    return mapper, rec, last_merge


def check_last_merge(mapper, last_merge, min_dist=0.15, border=1e-4):
    """The keep decision of every scan point in the run's last merge, held
    against a kd-tree on the host built from the map as it stood before
    that merge: equal except where the distance lies within ``border`` of
    ``min_dist``.  (Scan points are tested against the map only, never
    against each other.)"""
    from scipy.spatial import cKDTree
    i, before, filtered, pose, count_before = last_merge
    old = before.to_numpy()["positions"]
    check(old.shape[0] == count_before,
          "default: the map before the last merge has another count than "
          "was recorded")
    now = mapper.map.local.to_numpy()["positions"]
    # insert() compacts the map and appends the kept scan points in order
    check(np.array_equal(now[:count_before], old),
          "default: the last merge changed points the map already held")
    new_pts = now[count_before:]
    sm = filtered.mask.cpu().numpy()
    scan_c = (filtered.positions.cpu().numpy()[sm].astype(np.float64)
              @ pose[:3, :3].T.astype(np.float64) + pose[:3, 3])
    dist, _ = cKDTree(old.astype(np.float64)).query(scan_c)
    # which scan points the port kept: each new map point is a scan point
    d_new, src = cKDTree(scan_c).query(new_pts.astype(np.float64))
    check(float(d_new.max()) < 1e-4 and len(set(src.tolist())) == len(src),
          "default: a point added by the last merge is not a scan point")
    kept = np.zeros(scan_c.shape[0], bool)
    kept[src] = True
    borderline = np.abs(dist - min_dist) < border
    wrong = (kept != (dist >= min_dist)) & ~borderline
    emit({"phase": "default_last_merge", "scan": i,
          "map_points_before": int(count_before),
          "scan_points": int(scan_c.shape[0]), "kept": int(kept.sum()),
          "pairs": int(scan_c.shape[0]) * int(count_before),
          "borderline_within_1e-4_m": int(borderline.sum()),
          "wrong_decisions": int(wrong.sum())})
    check(int(wrong.sum()) == 0,
          f"default: {int(wrong.sum())} keep decisions of the last merge "
          "differ from the kd-tree's outside the borderline band")


def check_default_map(mapper, rec, n_scans):
    m = mapper.get_map()
    check(sorted(m) == ["positions"],
          f"default: the map carries descriptors {sorted(m)}")
    check(np.isfinite(m["positions"]).all(), "non-finite map positions")
    check(len(mapper.get_trajectory()) == n_scans,
          "trajectory length differs from the number of scans")
    check(rec["valid_points_per_scan_min"] >= 40_000,
          "fewer than 40,000 valid points in a scan")
    c = rec["map_counts"]
    check(all(b >= a for a, b in zip(c, c[1:])),
          f"default: the map shrank under a config that only adds: {c}")
    check(all(cap >= n for cap, n in zip(rec["map_capacities"], c)),
          "default: a map count exceeds its capacity")
    ref = mapper.icp._ref
    nrm = torch.linalg.norm(ref.descriptors["normals"][ref.mask], dim=1)
    check(float((nrm - 1.0).abs().max()) < 1e-3,
          "default: a reference normal is not unit length")


def p2point_icp(bound: bool):
    """The ``icp:`` section of the ``p2point`` phase: the default one with
    the point-to-point minimizer, the median and surface-normal outlier
    filters and a step filter; ``bound`` adds a bound checker wide enough
    for the priors' noise."""
    checkers = [
        {"CounterTransformationChecker": {"maxIterationCount": 40}},
        {"DifferentialTransformationChecker": {
            "minDiffRotErr": 0.001, "minDiffTransErr": 0.001,
            "smoothLength": 4}},
    ]
    if bound:
        checkers.append({"BoundTransformationChecker": {
            "maxRotationNorm": 0.8, "maxTranslationNorm": 1.0}})
    return {
        "readingDataPointsFilters": [
            {"RandomSamplingDataPointsFilter": {"prob": 0.75}}],
        "readingStepDataPointsFilters": [
            {"RandomSamplingDataPointsFilter": {"prob": 0.9}}],
        "referenceDataPointsFilters": [
            {"SurfaceNormalDataPointsFilter": {"knn": 10}}],
        "matcher": {"KDTreeMatcher": {"knn": 1}},
        "outlierFilters": [
            {"MedianDistOutlierFilter": {"factor": 3.0}},
            {"SurfaceNormalOutlierFilter": {"maxAngle": 1.4}}],
        "errorMinimizer": "PointToPointErrorMinimizer",
        "transformationCheckers": checkers,
    }


def finish_no_radius_phase(mapper, rec, priors, poses):
    """Accuracy, iteration time and launch gates shared by the phases that
    search without a radius; emits the record."""
    phase, n = rec["phase"], rec["scans"]
    est = mapper.get_trajectory().poses
    prior_ate = ate(priors[1:n], poses[1:n])
    rec_ate = ate(est[1:], poses[1:n])
    its = rec["icp_iterations"][1:]
    launch = rec["launches"]
    n_merges = sum(rec["merged"])  # the bootstrap scan included
    last_n = int(mapper.map.local.capacity)
    rec.update({
        "prior_ate_m": prior_ate, "recovered_ate_m": rec_ate,
        "mean_icp_iterations": statistics.mean(its),
        "merges": n_merges,
        "pairs_normals_last": last_n * last_n,
        "pairs_normals_last_valid": rec["final_map_count"] ** 2,
        "pairs_matcher_pass_last": rec["valid_points_per_scan_min"]
        * rec["final_map_count"],
    })
    if "solve" in rec["phase_ms_steady_total"]:
        # the per-scan step's solve phase, over the steady-state scans
        rec["ms_per_icp_iteration"] = (
            rec["phase_ms_steady_total"]["solve"] / sum(its[1:]))
    else:
        # the stepwise path records no phases: whole steady scans on the
        # host clock, merges included
        rec["host_ms_per_icp_iteration_merges_included"] = (
            sum(rec["per_scan_ms"][2:]) / sum(its[1:]))
    emit(rec)
    check_default_map(mapper, rec, n)
    check(rec_ate < prior_ate / 3.0,
          f"{phase}: recovered ATE {rec_ate} not below a third of the "
          f"prior's {prior_ate}")
    check(statistics.mean(its) > 1.0, f"{phase}: the solver did not iterate")
    check(launch["sweep_knn"] == 0 and launch["radius_pca[D=3]"] == 0,
          f"{phase}: a sweep kernel ran on the path without a radius: "
          f"{launch}")
    # every count below is a reading of the wrapper's counter
    pd = launch["knn_brute[D=3,k=1,point_distance]"]
    mt = launch["knn_brute[D=3,k=1,matcher]"]
    check(launch["knn_brute[D=3,k=10,normals]"] == n_merges,
          f"{phase}: {n_merges} merges but "
          f"{launch['knn_brute[D=3,k=10,normals]']} normals passes")
    check(launch["sym_eig[D=3]"] == n_merges,
          f"{phase}: {n_merges} merges but {launch['sym_eig[D=3]']} "
          "launches of the eigensolve")
    check(pd == n_merges - 1,
          f"{phase}: {n_merges} merges (the first creates the map) but "
          f"{pd} PointDistance searches")
    check(mt >= n - 1, f"{phase}: fewer matcher passes than scans: {launch}")
    check(pd + mt == launch.get("knn_brute[D=3,k=1]", 0),
          f"{phase}: k = 1 launches outside PointDistance and the solve: "
          f"{launch}")
    # the unbounded k = 1 matcher is the grid search, whose fallback is
    # one knn_brute launch a pass
    check(launch.get("knn_grid[D=3]", 0) == mt,
          f"{phase}: {mt} matcher passes of knn_brute but "
          f"{launch.get('knn_grid[D=3]', 0)} of knn_grid")


def check_solve_sync(rec):
    """Every steady scan's solve was checked, and those that replayed a
    graph they had made no synchronising call (today's gate; before the
    solve was a graph for point-to-point, one read per iteration)."""
    sc, phase = rec["solve_sync_check"], rec["phase"]
    checked = sc.get("solves_checked", 0) + sc.get("capture_solves_checked",
                                                   0)
    check(checked == rec["scans"] - 2,
          f"{phase}: {sc} (not every steady solve was checked)")
    check(sc.get("solve_syncs", 0) == 0,
          f"{phase}: a steady solve synchronised: {sc}")


STEP_PROB = 0.9  # the step filter's keep probability in p2plane_step


def hold_card_vs_cpu(mapper, phase):
    """The last scan's solve on the card (a graph replay) against the same
    solve on the CPU (the Python loop, plain versions of the kernels) on
    copies of the same inputs, drawing the same keyed step draws (seed and
    solve index): T within 1e-4."""
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch import se3
    from norlab_icp_mapper_tpu_torch.icp import engine
    icp = mapper.icp
    filtered, prior = mapper.last_scan
    reading = se3.apply(torch.as_tensor(prior, device="cuda"), filtered)
    if len(icp.reading_filters):
        reading = icp.reading_filters._apply_impl(reading, mapper.draws)
    ref = icp._ref
    args = (reading.positions, reading.mask, ref.positions,
            icp.check_reference(ref), ref.mask, icp._ref_pack)
    g = icp.solve(*args, draws=mapper.draws)
    index = icp.last_solve_index
    cpu = [t.cpu() for t in args[:5]]
    pack = icp.build_ref_pack(nt.PointBatch(cpu[2], cpu[4], {}))
    t0 = time.time()
    out = engine._icp_solve(
        *cpu, pack, step_filters=icp.reading_step_filters,
        draws=nt.DrawSource(mapper.draws.seed, "cpu"), solve_index=index,
        **icp.solve_config())
    cpu_s = time.time() - t0
    diff = float((g.correction.cpu() - out[0]).abs().max())
    emit({"phase": f"{phase}_card_vs_cpu", "solve_index": index,
          "iterations_card": int(g.iterations), "iterations_cpu": int(out[2]),
          "T_max_abs_diff": diff, "overlap_card": float(g.overlap),
          "overlap_cpu": float(out[1]), "cpu_solve_s": cpu_s})
    check(diff <= 1e-4, f"{phase}: the card's solve differs from the CPU's "
                        f"by {diff} (> 1e-4)")


STEP_OCTREE = {"OctreeGridDataPointsFilter": {"maxSizeByNode": 0.2,
                                               "samplingMethod": 1}}


def step_config(octree=False):
    """``examples/config_p2plane.yaml`` with a random step filter (prob
    0.9), in memory; ``octree`` puts a random octree decimation (0.2 m) in
    front of it: a chain that is not row-local."""
    cfg = config_dict("config_p2plane.yaml")
    cfg["icp"]["readingStepDataPointsFilters"] = (
        [STEP_OCTREE] if octree else []) + [
        {"RandomSamplingDataPointsFilter": {"prob": STEP_PROB}}]
    return cfg


def phase_step_filters(scans, priors, poses):
    """``examples/config_p2plane.yaml`` with a random step filter
    (``RandomSamplingDataPointsFilter``, prob 0.9) in memory, over the 18
    scans step-locked, steady scans under ``"error"``: every solve one
    graph replay whose step keep mask is one ``philox_keep`` launch per
    matcher pass, on the sorted reading with the sort as its rows; the last
    solve against its Python loop (bit for bit) and against the CPU's
    (1e-4), its first pass against the permute path (bit for bit); ATE
    below a third of the prior's.  Then ``p2plane_step_octree``: the same
    with a random octree decimation in front (not row-local: the permute
    path, ``philox`` drawing its priorities), graph against loop bit for
    bit, ATE below a third of the prior's.  Returns both drives'
    launches."""
    cfg = step_config()
    mapper, rec = drive("config_p2plane.yaml", scans, priors,
                        "p2plane_step", strict=True, config=cfg)
    est = mapper.get_trajectory().poses
    prior_ate = ate(priors[1:], poses[1:])
    its = rec["icp_iterations"][1:]
    rec.update({"step_filters": cfg["icp"]["readingStepDataPointsFilters"],
                "prior_ate_m": prior_ate,
                "recovered_ate_m": ate(est[1:], poses[1:]),
                "mean_icp_iterations": statistics.mean(its),
                "ms_per_gn_iteration": (rec["phase_ms_steady_total"]["solve"]
                                        / sum(its[1:]))})
    emit(rec)
    launch = rec["launches"]
    check_map(mapper, rec, len(scans))
    check_sync(rec)
    check_graph_launches("p2plane_step", launch, len(scans))
    check(rec["recovered_ate_m"] < prior_ate / 3.0,
          f"p2plane_step: recovered ATE {rec['recovered_ate_m']} not below "
          f"a third of the prior's {prior_ate}")
    check(launch["philox_keep"] > 0
          and launch.get("sweep_knn[D=3,k=3]", 0) > 0,
          f"p2plane_step: the step draws or the matcher not on the card: "
          f"{launch}")
    loop = hold_graph_solve(mapper, "p2plane_step")
    hold_step_paths("p2plane_step", loop)
    hold_card_vs_cpu(mapper, "p2plane_step")
    queue_scan_launches("p2plane_step", cfg, scans, priors)

    ocfg = step_config(octree=True)
    omapper, orec = drive("config_p2plane.yaml", scans, priors,
                          "p2plane_step_octree", strict=True, config=ocfg)
    orec.update({"step_filters": ocfg["icp"]["readingStepDataPointsFilters"],
                 "prior_ate_m": prior_ate,
                 "recovered_ate_m": ate(omapper.get_trajectory().poses[1:],
                                        poses[1:])})
    emit(orec)
    olaunch = orec["launches"]
    check_small_map(omapper, orec, len(scans))
    check_sync(orec)
    check_graph_launches("p2plane_step_octree", olaunch, len(scans))
    check(orec["recovered_ate_m"] < prior_ate / 3.0,
          f"p2plane_step_octree: recovered ATE {orec['recovered_ate_m']} "
          f"not below a third of the prior's {prior_ate}")
    check(olaunch["philox"] > 0 and olaunch["philox_keep"] > 0,
          f"p2plane_step_octree: the step draws not on the card: {olaunch}")
    oloop = hold_graph_solve(omapper, "p2plane_step_octree")
    hold_step_paths("p2plane_step_octree", oloop)
    return launch, olaunch


# ---------------------------------------------------------------------------
# octree leaves (maxPointByNode > 1), the filter zoo, overflow records,
# checkpoints, keyframes and the pose graph
# ---------------------------------------------------------------------------

def config_dict(name, k_octree=None, extra_input=()):
    """A bundled YAML as a dict, edited in memory (the file stays as it is):
    ``maxPointByNode`` on its OctreeMapperModule, filters appended to its
    input chain."""
    import yaml
    with open(os.path.join(HERE, "examples", name)) as fh:
        cfg = yaml.safe_load(fh)
    if k_octree is not None:
        for m in cfg["mapper"]["mapperModule"]:
            if "OctreeMapperModule" in m:
                m["OctreeMapperModule"]["maxPointByNode"] = k_octree
    cfg["input"] = list(cfg.get("input") or []) + list(extra_input)
    return cfg


def check_small_map(mapper, rec, n_scans):
    """What check_map holds, for maps that other configs make smaller."""
    m = mapper.get_map()
    phase = rec["phase"]
    check(m["positions"].shape[0] > 10_000,
          f"{phase}: final map holds {m['positions'].shape[0]} points")
    check(np.isfinite(m["positions"]).all(), f"{phase}: non-finite map")
    nrm = np.linalg.norm(m["normals"], axis=1)
    check(np.abs(nrm - 1.0).max() < 1e-3, f"{phase}: a normal is not unit")
    check(len(mapper.get_trajectory()) == n_scans,
          f"{phase}: trajectory length differs from the number of scans")


def union_cloud(scans, poses, seed, dev):
    """The octree's input at full width: a map of capacity 131,072 and a
    scan of capacity 49,152 in the map frame, concatenated (the union the
    OctreeMapperModule decimates)."""
    import norlab_icp_mapper_tpu_torch as nt
    world_pts = numpy_map(scans[:8], poses[:8])
    rng = np.random.default_rng(seed)
    limit = int(0.84 * MAP_CAPACITY)  # 110,100 points
    if world_pts.shape[0] > limit:
        world_pts = world_pts[np.sort(rng.choice(world_pts.shape[0], limit,
                                                 replace=False))]
    mp = nt.PointBatch.from_numpy(world_pts, capacity=MAP_CAPACITY,
                                  device=dev)
    sc = nt.PointBatch.from_numpy(scans[8], capacity=SCAN_CAPACITY,
                                  device=dev)
    sc = nt.se3.apply(torch.from_numpy(poses[8]), sc)
    return (torch.cat([mp.positions, sc.positions]),
            torch.cat([mp.mask, sc.mask]))


def hold_octree_select(scans, poses, seed, k=4, voxel=0.15):
    """``_octree_select`` on the card against the same function on CPU
    tensors, the same draws, on the full union: keep masks and centroids
    bit for bit, for the four sampling methods."""
    from norlab_icp_mapper_tpu_torch.ops import voxel as V
    pos, mask = union_cloud(scans, poses, seed, "cpu")
    n = pos.shape[0]
    g = torch.Generator().manual_seed(seed)
    prio = torch.randint(0, 1 << 15, (n,), generator=g)
    leaf = torch.randint(0, 1 << 30, (n,), generator=g)
    gpu = [t.cuda() for t in (pos, mask, prio, leaf)]
    out = {"phase": "octree_select_card_vs_cpu", "rows": n,
           "valid": int(mask.sum()), "maxPointByNode": k, "voxel": voxel}
    for method in range(4):
        kc, cc = V.voxel_select(pos, mask, voxel, method, prio, k,
                                leaf_keys=leaf)
        kg, cg = V.voxel_select(gpu[0], gpu[1], voxel, method, gpu[2], k,
                                leaf_keys=gpu[3])
        same_keep = bool(torch.equal(kg.cpu(), kc))
        same_cent = bool(torch.equal(cg.cpu()[kc], cc[kc]))
        ms = time_cuda(lambda: V.voxel_select(gpu[0], gpu[1], voxel, method,
                                              gpu[2], k, leaf_keys=gpu[3]),
                       reps=5, warmup=1)
        out[f"method{method}"] = {"kept": int(kc.sum()),
                                  "keep_bit_identical": same_keep,
                                  "centroid_bit_identical": same_cent,
                                  "card_ms": ms}
        check(same_keep and same_cent,
              f"octree_k: method {method} on the card differs from the CPU "
              f"run (keep equal: {same_keep}, centroids equal: {same_cent})")
    k1, _ = V.voxel_select(pos, mask, voxel, 0)
    out["kept_k1_method0"] = int(k1.sum())
    check(out["method0"]["kept"] < out["kept_k1_method0"],
          "octree_k: maxPointByNode > 1 kept no fewer points than 1")
    emit(out)


def phase_octree_k(scans, poses, seed, identity_map_count):
    """examples/config.yaml with maxPointByNode: 4 over the sequence:
    steady scans without a blocking read, a smaller map than K = 1 builds;
    then the selection on the card against the CPU."""
    mapper, rec = drive("config.yaml", scans, poses, "octree_k", strict=True,
                        config=config_dict("config.yaml", k_octree=4))
    rec["config"] = ("examples/config.yaml, maxPointByNode: 4 on its "
                     "OctreeMapperModule")
    rec["identity_final_map_count"] = identity_map_count
    emit(rec)
    check_small_map(mapper, rec, len(scans))
    check_sync(rec)
    check(rec["final_map_count"] < identity_map_count,
          f"octree_k: the map holds {rec['final_map_count']} points, not "
          f"fewer than the K = 1 map's {identity_map_count}")
    launch = rec["launches"]
    check(launch.get("sweep_knn[D=3,k=1]", 0) > 0
          and launch["radius_pca[D=3]"] == len(scans),
          f"octree_k: a kernel of the path was not launched: {launch}")
    check_graph_launches("octree_k", launch, len(scans))
    hold_octree_select(scans, poses, seed)
    return launch


FILTER_CASES = [
    ("MaxPointCountDataPointsFilter", {"maxCount": 30000}),
    ("OrientNormalsDataPointsFilter", {"towardCenter": 1}),
    ("OctreeGridDataPointsFilter", {"maxSizeByNode": 0.15,
                                    "samplingMethod": 1}),
    ("OctreeGridDataPointsFilter", {"maxSizeByNode": 0.15,
                                    "samplingMethod": 3}),
    ("ObservationDirectionDataPointsFilter", {"x": 0.1, "y": 0.0,
                                              "z": -0.2}),
    ("MaxDistDataPointsFilter", {"dim": -1, "maxDist": 20.0}),
    ("MinDistDataPointsFilter", {"dim": -1, "minDist": 3.0}),
    ("ShadowDataPointsFilter", {"eps": 0.2}),
    ("VoxelGridDataPointsFilter", {"vSizeX": 0.1, "vSizeY": 0.1,
                                   "vSizeZ": 0.1, "useCentroid": 1}),
    ("IdentityDataPointsFilter", {}),
    ("RemoveNaNDataPointsFilter", {}),
]
FILTER_TOL = 1e-6  # descriptors and positions: the same f32 operations

FILTERS_INPUT = [
    {"RemoveNaNDataPointsFilter": {}},
    {"MinDistDataPointsFilter": {"dim": -1, "minDist": 1.0}},
    {"MaxDistDataPointsFilter": {"dim": -1, "maxDist": 50.0}},
    {"VoxelGridDataPointsFilter": {"vSizeX": 0.05, "vSizeY": 0.05,
                                   "vSizeZ": 0.05, "useCentroid": 1}},
    {"ObservationDirectionDataPointsFilter": {}},
]


def max_diff(a, b) -> float:
    """Largest |a - b|; a NaN on one side only counts as infinite, NaN on
    both sides as equal."""
    nan_a, nan_b = torch.isnan(a), torch.isnan(b)
    if not torch.equal(nan_a, nan_b):
        return float("inf")
    d = (torch.where(nan_a, 0.0, a) - torch.where(nan_b, 0.0, b)).abs()
    return float(d.max()) if d.numel() else 0.0


def phase_filters(scans, seed):
    """Each of the ten filters on a 49,152-point scan on the card against
    its run on the CPU (same draws); then a config whose input chain uses
    RemoveNaN, MinDist, MaxDist, VoxelGrid and ObservationDirection over
    the sequence, steady scans without a blocking read."""
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch.filters import core as F
    rng = np.random.default_rng(seed + 3)
    pts = scans[8].copy()
    pts[rng.random(pts.shape[0]) < 0.01] = np.nan
    nrm = rng.normal(size=pts.shape).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    prio = rng.integers(0, 1 << 15, size=SCAN_CAPACITY)
    cpu = nt.PointBatch.from_numpy(pts, {"normals": nrm},
                                   capacity=SCAN_CAPACITY, device="cpu")
    # NaN rows of the scan stay valid here, as a reader would leave them,
    # except for the voxel filters, which need finite coordinates
    finite = cpu.mask & torch.isfinite(cpu.positions).all(1)
    recs = []
    for name, params in FILTER_CASES:
        f = F.filter_registry.create(name, dict(params))
        base = cpu if name.startswith(("RemoveNaN", "Identity")) \
            else cpu.with_mask(finite)
        gb = base.to("cuda")
        src = lambda site, n: prio[:n]  # noqa: E731
        oc = f.apply(base, nt.DrawSource(0, "cpu", src))
        og = f.apply(gb, nt.DrawSource(0, "cuda", src))
        torch.cuda.synchronize()
        mask_eq = bool(torch.equal(og.mask.cpu(), oc.mask))
        m = oc.mask
        errs = {"positions": max_diff(og.positions.cpu()[m], oc.positions[m])}
        for k, v in oc.descriptors.items():
            errs[k] = max_diff(og.descriptors[k].cpu()[m], v[m])
        ms = time_cuda(lambda: f.apply(gb, nt.DrawSource(0, "cuda", src)))
        rec = {"filter": name, "params": params, "kept": int(m.sum()),
               "valid_in": int(base.mask.sum()), "masks_equal": mask_eq,
               "max_abs_err": errs, "card_ms": ms}
        recs.append(rec)
        check(mask_eq and max(errs.values()) <= FILTER_TOL,
              f"filters: {name} on the card differs from the CPU: {rec}")
    emit({"phase": "filters_card_vs_cpu", "scan_capacity": SCAN_CAPACITY,
          "tolerance": FILTER_TOL, "filters": recs})
    return recs


def phase_filters_drive(scans, poses):
    mapper, rec = drive("config.yaml", scans, poses, "filters", strict=True,
                        config=config_dict("config.yaml",
                                           extra_input=FILTERS_INPUT))
    rec["config"] = ("examples/config.yaml, input chain + RemoveNaN, "
                     "MinDist, MaxDist, VoxelGrid, ObservationDirection")
    emit(rec)
    check_small_map(mapper, rec, len(scans))
    check_sync(rec)
    check("observationDirections" in mapper.get_map(),
          "filters: the map lost the ObservationDirection descriptor")
    check_graph_launches("filters", rec["launches"], len(scans))
    return rec["launches"]


def phase_tracing(scans, priors):
    """The point-to-plane config with the overflow sink installed: steady
    scans without a blocking read, and ``overflow_totals()`` equal to the
    sum of the counts the passes returned (each pass's ``last_overflow``,
    taken at every call).  Two counts are also held against ones made
    without the pass: the last SurfaceNormal pass's recorded count against
    the plain version's on a copy of its input, and an insert planted past
    the buffer's capacity against the number of points it must drop."""
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch.ops.pca import radius_pca_normals_plain
    from norlab_icp_mapper_tpu_torch.points import insert
    from norlab_icp_mapper_tpu_torch.utils import tracing
    seen = {"icp_matcher_sweep": [], "dynamic_points_sweep": [],
            "surface_normal_sweep": []}
    recorded = {}
    normals_input = {}

    def sink(name, value):
        recorded.setdefault(name, []).append(value)
        tracing.accumulate_overflow(name, value)

    def tap(obj, method, attr_of, key):
        inner = getattr(obj, method)

        def tapped(*a, **kw):
            out = inner(*a, **kw)
            seen[key].append(attr_of().last_overflow)
            return out
        setattr(obj, method, tapped)

    def setup(m):
        tap(m.icp, "solve", lambda: m.icp, "icp_matcher_sweep")
        dyn = m.map.modules[0]
        tap(dyn, "update_map", lambda: dyn, "dynamic_points_sweep")
        sn = m.post_filters.filters[0]
        inner = sn._apply_radius_pca

        def keep_input(batch, k, max_dist):
            # a copy: nothing the mapper does later can change it
            normals_input.update(positions=batch.positions.clone(),
                                 mask=batch.mask.clone(), k=k,
                                 max_dist=max_dist)
            return inner(batch, k, max_dist)
        sn._apply_radius_pca = keep_input
        tap(sn, "_apply_radius_pca", lambda: sn, "surface_normal_sweep")

    base = tracing.overflow_totals()
    tracing.set_overflow_sink(sink)
    try:
        mapper, rec = drive("config_p2plane.yaml", scans, priors, "tracing",
                            strict=True, setup=setup)
        # the SurfaceNormal filter's pass, as it calls the kernel
        # (filters/core.py), through the plain version
        ni = normals_input
        plain_ov = int(radius_pca_normals_plain(
            ni["positions"], ni["positions"], ni["mask"], ni["mask"],
            max_radius=ni["max_dist"], q_tile=1024,
            W=2048 if ni["max_dist"] <= 1.0 else 4096,
            min_count=min(ni["k"], 3))[3])
        # 1,000 points in a buffer of 1,024, then 100 more: 76 dropped
        dst = nt.PointBatch.from_numpy(
            scans[0][:1000], capacity=1024, device="cuda")
        src = nt.PointBatch.from_numpy(
            scans[0][1000:1100], capacity=128, device="cuda")
        ins_base = tracing.overflow_totals().get("points_insert", 0)
        insert(dst, src)
        planted = tracing.overflow_totals()["points_insert"] - ins_base
    finally:
        tracing.set_overflow_sink(None)
    tot = tracing.overflow_totals()
    delta = {k: v - base.get(k, 0) for k, v in tot.items()}
    delta["points_insert"] -= planted
    sums = {k: sum(int(t) for t in v) for k, v in seen.items()}
    last_normals = int(recorded["surface_normal_sweep"][-1])
    rec.update({"overflow_totals": delta, "wrapper_overflow_sums": sums,
                "passes_recorded": {k: len(v) for k, v in seen.items()},
                "last_surface_normal_pass": {"recorded": last_normals,
                                             "plain_version": plain_ov},
                "planted_insert_dropped": {"recorded": planted,
                                           "expected": 76}})
    emit(rec)
    check_sync(rec)
    check(last_normals == plain_ov and plain_ov > 0,
          f"tracing: the last SurfaceNormal pass recorded {last_normals} "
          f"overflowing tiles, its plain version counts {plain_ov}")
    check(planted == 76, f"tracing: an insert of 100 points into 24 free "
                         f"slots recorded {planted} dropped, not 76")
    for k, v in sums.items():
        check(delta.get(k, 0) == v and len(seen[k]) > 0,
              f"tracing: overflow_totals()[{k}] = {delta.get(k)} but the "
              f"passes returned {v} over {len(seen[k])} calls")
    if rec["mapper_waits"]["remerge"] == 0:
        check(delta.get("points_insert", 0) == 0,
              f"tracing: inserts dropped points without a re-merge: {delta}")
    return rec["launches"]


def rot_angle(R) -> float:
    """The angle of a rotation matrix, by atan2 (arccos of the trace loses
    half the digits near 0)."""
    R = np.asarray(R, np.float64)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return float(np.arctan2(0.5 * np.linalg.norm(w),
                            0.5 * (np.trace(R) - 1.0)))


def phase_checkpoint(p2_mapper, scans, priors):
    """Save the point-to-plane mapper; load into a fresh Mapper with
    ``localization_only=True``; register the last scan: its pose within
    1 mm and 0.1 degree of the pose the offline mapper itself gives that
    scan once frozen (both register against the same map)."""
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch.utils import (load_checkpoint,
                                                   save_checkpoint)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "checkpoint_p2plane.npz")
    t0 = time.time()
    save_checkpoint(path, p2_mapper)
    save_s = time.time() - t0
    size = os.path.getsize(path)
    m2 = nt.Mapper(os.path.join(HERE, "examples", "config_p2plane.yaml"),
                   is_3d=True, device="cuda", seed=0)
    t0 = time.time()
    load_checkpoint(path, m2, localization_only=True)
    load_s = time.time() - t0
    os.remove(path)
    n_map = m2.map.known_count()
    stamp = int(len(scans) * 1e8)
    mapped = p2_mapper.get_trajectory().poses[-1]
    p2_mapper.set_is_mapping(False)
    for m in (m2, p2_mapper):
        # the reading filter's random sampling: the same draws for both
        m.draws = nt.DrawSource(1, m.device)
        batch = nt.PointBatch.from_numpy(scans[-1], capacity=SCAN_CAPACITY,
                                         device="cuda")
        m.process_input(m.apply_input_filters(batch), priors[-1], stamp)
        m.drain()
    pose, offline = m2.get_pose(), p2_mapper.get_pose()
    dt = float(np.linalg.norm(pose[:3, 3] - offline[:3, 3]))
    dr = rot_angle(pose[:3, :3].T.astype(np.float64) @ offline[:3, :3])
    rec = {"phase": "checkpoint", "bytes": size, "save_s": save_s,
           "load_s": load_s, "map_points": n_map,
           "map_points_after_scan": m2.map.known_count(),
           "pose_diff_m": dt, "pose_diff_deg": float(np.degrees(dr)),
           "pose_diff_to_mapping_run_m": float(np.linalg.norm(
               pose[:3, 3] - mapped[:3, 3])),
           "trajectory_length": len(m2.get_trajectory())}
    emit(rec)
    check(not m2.get_is_mapping(), "checkpoint: mapping was not frozen")
    check(rec["map_points_after_scan"] == n_map,
          "checkpoint: the localization-only mapper changed its map")
    check(dt <= 1e-3 and np.degrees(dr) <= 0.1,
          f"checkpoint: the pose differs from the offline one by {dt} m and "
          f"{np.degrees(dr)} degrees")


LOOP_SCANS = 36  # one lap (31.4 scans) and a little more
LOOP_CENTER = (30.75, 10.0)  # the third box, [30, 31.5] x [8, 12]
LOOP_RADIUS = 4.0
# candidate pairs: keyframes at least 5 apart in the store and at most 3 m
# apart in space, i.e. the places the robot came back to.  Farther pairs
# see the box from its other side, and their registrations can slide by
# its width onto the face they do see (the reference's algorithm alike):
# the phase also runs ``refine_trajectory``'s default of 8 m and records
# how many of its closures are false.
LOOP_MAX_DIST = 3.0
# a closure whose measured relative pose is this far from the true one
FALSE_CLOSURE_M = 0.5


def make_loop(seed, n_scans=LOOP_SCANS, step=0.8):
    """The robot drives a closed loop around a box: ``n_scans`` scans
    ``step`` m apart on a circle (one lap and a little more), heading along
    it; scans in the sensor frame and true poses, as ``make_sequence``."""
    rng = np.random.default_rng(seed + 11)
    dirs = lidar_dirs()
    G = rot_z(WORLD_YAW)
    scans, poses = [], []
    for i in range(n_scans):
        th = i * step / LOOP_RADIUS
        P = rot_z(th + np.pi / 2)
        P[:3, 3] = [LOOP_CENTER[0] + LOOP_RADIUS * np.cos(th),
                    LOOP_CENTER[1] + LOOP_RADIUS * np.sin(th), SENSOR_HEIGHT]
        rng_m = ray_cast(P[:3, 3], dirs @ P[:3, :3].T)
        rng_m = rng_m + rng.normal(scale=0.01, size=rng_m.shape)
        scans.append((dirs * rng_m[:, None]).astype(np.float32))
        poses.append((G @ P).astype(np.float32))
    return scans, poses


def drift(true_poses, seed):
    """Odometry that drifts: the true relative motions, each multiplied by
    seeded SE(3) noise (the drift of the JAX package's keyframe test,
    tests/test_pose_graph_batched.py)."""
    from norlab_icp_mapper_tpu_torch import se3
    rng = np.random.default_rng(seed + 13)
    sigma = np.array([0.04, 0.04, 0.0, 0.0, 0.0, 0.015], np.float32)
    out = [true_poses[0]]
    for i in range(1, len(true_poses)):
        rel = np.linalg.inv(true_poses[i - 1]) @ true_poses[i]
        noise = se3.exp_se3(torch.from_numpy(
            rng.normal(size=6).astype(np.float32) * sigma)).numpy()
        out.append((out[-1] @ rel @ noise).astype(np.float32))
    return out


def hold_registrations(kf_pos, kf_mask, poses, cand, normals, iters):
    """``register_pairs_batched`` with the kernels against its plain
    version on the card, on the first candidate pairs: T within 1e-4 m and
    1e-4 rad, overlap and rms within 1e-5."""
    from norlab_icp_mapper_tpu_torch.slam import pose_graph as PG
    pairs = cand[:3]
    ii = torch.tensor([i for i, _ in pairs], device="cuda")
    jj = torch.tensor([j for _, j in pairs], device="cuda")
    rel0 = np.stack([np.linalg.inv(poses[i]) @ poses[j] for i, j in pairs])
    args = (kf_pos[jj], kf_mask[jj], kf_pos[ii], normals[ii], kf_mask[ii],
            rel0)
    torch.cuda.synchronize()
    t0 = time.time()
    Tk, ok, rk = PG.register_pairs_batched(*args, iters=iters)
    torch.cuda.synchronize()
    kernel_s = time.time() - t0
    t0 = time.time()
    Tp, op, rp = PG.register_pairs_batched_plain(*args, iters=iters)
    torch.cuda.synchronize()
    plain_s = time.time() - t0
    Tk, Tp = Tk.cpu().numpy(), Tp.cpu().numpy()
    dt = max(float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
             for a, b in zip(Tk, Tp))
    dr = max(rot_angle(a[:3, :3].T.astype(np.float64) @ b[:3, :3])
             for a, b in zip(Tk, Tp))
    d_ov = float((ok - op).abs().max())
    d_rms = float((rk - rp).abs().max())
    rec = {"pairs": [list(p) for p in pairs], "T_max_diff_m": dt,
           "T_max_diff_rad": dr, "overlap_max_diff": d_ov,
           "rms_max_diff": d_rms, "kernel_ms_per_pair":
           kernel_s * 1e3 / len(pairs),
           "plain_ms_per_pair": plain_s * 1e3 / len(pairs)}
    check(dt <= 1e-4 and dr <= 1e-4 and d_ov <= 1e-5 and d_rms <= 1e-5,
          f"posegraph: the registrations with the kernels differ from the "
          f"plain version's: {rec}")
    return rec


def clock_calls(targets):
    """Replace each ``(owner, attribute, key)`` by a wrapper that
    synchronizes the card around every call and keeps, under ``key``, the
    number of calls, the first call's seconds and the total; a key ending in
    ``()`` names a factory, whose returned functions are clocked instead
    (``torch.func.jacfwd``: its first call traces).  Returns the record and
    a function that puts the originals back."""
    rec, undo = {}, []

    def clocked(key, fn):
        r = rec.setdefault(key, {"calls": 0, "first_s": None,
                                 "total_s": 0.0})

        def call(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.time()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            dt = time.time() - t0
            if r["first_s"] is None:
                r["first_s"] = dt
            r["calls"] += 1
            r["total_s"] += dt
            return out
        return call

    for owner, attr, key in targets:
        inner = getattr(owner, attr)
        if key.endswith("()"):
            def factory(*a, _inner=inner, _key=key, **kw):
                return clocked(_key, _inner(*a, **kw))
            setattr(owner, attr, factory)
        else:
            setattr(owner, attr, clocked(key, inner))
        undo.append((owner, attr, inner))

    def restore():
        for owner, attr, inner in undo:
            setattr(owner, attr, inner)
    return rec, restore


def closure_errors(kf_pos, kf_mask, kf_poses, true_t, true_R, max_dist,
                   defaults):
    """The loop closures ``refine_trajectory`` accepts at ``max_dist`` (its
    other settings at their defaults), each measured relative pose against
    the true one: ``(pairs, translation errors m, rotation errors deg)``."""
    from norlab_icp_mapper_tpu_torch.slam import pose_graph as PG
    ei, ej, Z, _ = PG.detect_loop_closures_batched(
        kf_pos, kf_mask, kf_poses, min_index_gap=defaults["min_index_gap"],
        max_dist=max_dist, min_overlap=defaults["min_overlap"],
        match_max_dist=defaults["match_max_dist"],
        iters=defaults["icp_iters"], normal_radius=defaults["normal_radius"],
        max_rms=defaults["max_rms"])
    dt, dr = [], []
    for i, j, z in zip(ei, ej, Z):
        R = true_R[i].T @ true_R[j]
        t = true_R[i].T @ (true_t[j] - true_t[i])
        dt.append(float(np.linalg.norm(z[:3, 3] - t)))
        dr.append(float(np.degrees(rot_angle(
            R.T.astype(np.float64) @ z[:3, :3]))))
    return list(zip(ei, ej)), dt, dr


def phase_posegraph(seed, rng):
    """A closed loop around a box, drifting odometry, examples/config.yaml
    (identity minimizer: the trajectory IS the odometry), keyframes every
    metre, then ``refine_trajectory``: at least one accepted loop closure,
    a smaller keyframe position error than the drift's, keyframe normals
    that end without overflow, and the registrations held against their
    plain version.  Also holds ``knn_brute`` and ``radius_pca`` at the
    shapes this path gives them."""
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch.slam import pose_graph as PG
    t0 = time.time()
    scans, truth = make_loop(seed)
    priors = drift(truth, seed)
    seq_s = time.time() - t0
    mapper = nt.Mapper(os.path.join(HERE, "examples", "config.yaml"),
                       is_3d=True, device="cuda", seed=0)
    mapper.enable_keyframes(min_distance=1.0)
    reset_counts()
    batches = [nt.PointBatch.from_numpy(s, capacity=SCAN_CAPACITY,
                                        device="cuda") for s in scans]
    t0 = time.time()
    for i, b in enumerate(batches):
        mapper.process_input(mapper.apply_input_filters(b), priors[i],
                             int(i * 1e8))
    mapper.drain()
    map_s = time.time() - t0
    map_launch = read_counts()
    kf_pos, kf_mask, kf_poses = mapper.get_keyframes()
    n_kf = kf_poses.shape[0]
    defaults = {k: v.default for k, v in inspect.signature(
        nt.Mapper.refine_trajectory).parameters.items()
        if v.default is not inspect.Parameter.empty}
    icp_iters, min_gap = defaults["icp_iters"], defaults["min_index_gap"]
    cand = PG._candidates(kf_poses, min_gap, LOOP_MAX_DIST)

    # the first call, cold, as an offline job makes it; its set-up split by
    # the calls it makes, each clocked between synchronizes
    split, restore = clock_calls([
        (PG, "keyframe_normals", "keyframe_normals"),
        (PG, "register_pairs_batched", "register_pairs_batched"),
        (PG, "optimize_pose_graph", "optimize_pose_graph"),
        (torch.linalg, "solve", "torch.linalg.solve"),
        (torch.linalg, "solve_ex", "torch.linalg.solve_ex"),
        (torch.func, "jacfwd", "torch.func.jacfwd()")])
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    try:
        before, after, info = mapper.refine_trajectory(
            max_dist=LOOP_MAX_DIST)
        torch.cuda.synchronize()
    finally:
        restore()
    refine_s = time.time() - t0
    launch = read_counts()
    knn_l = launch.get("knn_brute[D=3,k=1]", 0)
    pca_l = launch["radius_pca[D=3]"]
    top = ("keyframe_normals", "register_pairs_batched",
           "optimize_pose_graph")
    split["rest_of_the_call"] = {
        "total_s": refine_s - sum(split[k]["total_s"] for k in top)}

    # keyframe i was taken at the scan whose prior it holds
    idx = [int(np.argmin([np.linalg.norm(p[:3, 3] - k[:3, 3])
                          for p in priors])) for k in kf_poses]
    true_t = np.stack([truth[i][:3, 3] for i in idx])
    true_R = np.stack([truth[i][:3, :3] for i in idx])

    def mean_err(poses):
        return float(np.linalg.norm(poses[:, :3, 3] - true_t, axis=1).mean())
    err_before, err_after = mean_err(before), mean_err(after)

    # refine_trajectory with every setting at its default (candidate pairs
    # within 8 m: across the box too), beside the 3 m run
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    _, after_def, info_def = mapper.refine_trajectory()
    torch.cuda.synchronize()
    default_s = time.time() - t0
    launch_def = read_counts()
    cand_def = PG._candidates(kf_poses, min_gap, defaults["max_dist"])
    closures = {}
    for name, dist, inf in (("3m", LOOP_MAX_DIST, info),
                            ("default", defaults["max_dist"], info_def)):
        pairs, dt, dr = closure_errors(kf_pos, kf_mask, kf_poses, true_t,
                                       true_R, dist, defaults)
        closures[name] = {
            "max_dist_m": dist, "pairs": [list(p) for p in pairs],
            "same_pairs_as_refine": pairs == inf["loop_closures"],
            "translation_error_m": dt, "rotation_error_deg": dr,
            "false": sum(e > FALSE_CLOSURE_M for e in dt)}
    default_run = {
        "max_dist_m": defaults["max_dist"], "candidate_pairs": len(cand_def),
        "loop_closures": len(info_def["loop_closures"]),
        "false_closures": closures["default"]["false"],
        "refine_s": default_s, "keyframe_error_after_m": mean_err(after_def),
        "launches_knn_brute_k1": launch_def.get("knn_brute[D=3,k=1]", 0),
        "launches_radius_pca": launch_def["radius_pca[D=3]"]}
    refs = sorted({i for i, _ in cand})
    ref_t = torch.tensor(refs, device="cuda")
    normals = torch.zeros_like(kf_pos)
    torch.cuda.synchronize()
    t0 = time.time()
    nrm, ov, Ws = PG.keyframe_normals(kf_pos[ref_t], kf_mask[ref_t],
                                      radius=1.0, return_overflow=True)
    torch.cuda.synchronize()
    normals_s = time.time() - t0
    normals[ref_t] = nrm
    reg = hold_registrations(kf_pos, kf_mask, kf_poses, cand, normals,
                             icp_iters)
    # where the refinement's time goes, warm: the whole call again, the
    # Gauss-Newton solve alone on the same graph
    t0 = time.time()
    mapper.refine_trajectory(max_dist=LOOP_MAX_DIST)
    torch.cuda.synchronize()
    refine_warm_s = time.time() - t0
    ei, ej, Z = PG.sequential_edges(before)
    lz = np.stack([np.linalg.inv(before[i]) @ before[j]
                   for i, j in info["loop_closures"]]).astype(np.float32)
    t0 = time.time()
    PG.optimize_pose_graph(before, ei + [i for i, _ in info["loop_closures"]],
                           ej + [j for _, j in info["loop_closures"]],
                           np.concatenate([Z, lz]), iters=10, device="cuda")
    gn_s = time.time() - t0
    rec = {"phase": "posegraph", "scans": len(scans), "step_m": 0.8,
           "loop_radius_m": LOOP_RADIUS, "sequence_s": seq_s,
           "mapping_s": map_s, "keyframes": n_kf, "candidate_pairs":
           len(cand), "loop_closures": len(info["loop_closures"]),
           "edges": info["n_edges"], "refine_s": refine_s,
           "refine_cold_split": split, "refine_warm_s": refine_warm_s,
           "gauss_newton_warm_s": gn_s,
           "keyframe_normals_s": normals_s,
           "refine_launches_knn_brute_k1": knn_l,
           "refine_launches_radius_pca": pca_l,
           "keyframe_error_before_m": err_before,
           "keyframe_error_after_m": err_after,
           "default_settings": default_run, "closures_against_truth":
           closures, "false_closure_m": FALSE_CLOSURE_M,
           "gn_costs": [float(c) for c in info["costs"]],
           "keyframe_normals_overflow": [int(v) for v in ov],
           "keyframe_normals_W": Ws, "registration_kernel_vs_plain": reg,
           "mapping_launches": map_launch}
    emit(rec)
    check(n_kf >= 12, f"posegraph: {n_kf} keyframes")
    check(len(info["loop_closures"]) >= 1, "posegraph: no loop closure")
    check(closures["3m"]["false"] == 0,
          f"posegraph: a closure of the 3 m run is false: {closures['3m']}")
    check(np.isfinite(after_def).all()
          and default_run["keyframe_error_after_m"] < err_before,
          "posegraph: the refinement with the default settings is not "
          f"finite or not below the drift's error: {default_run}")
    check(default_run["launches_knn_brute_k1"] == len(cand_def) * icp_iters,
          f"posegraph: {default_run['launches_knn_brute_k1']} knn_brute "
          f"launches for {len(cand_def)} pairs at the defaults")
    check(err_after < err_before,
          f"posegraph: keyframe error {err_after} m after refinement, not "
          f"below the drift's {err_before} m")
    check(all(v == 0 for v in ov),
          f"posegraph: keyframe normals ended with overflow {list(ov)}")
    check(knn_l == len(cand) * icp_iters,
          f"posegraph: {knn_l} knn_brute launches for {len(cand)} pairs x "
          f"{icp_iters} iterations")
    check(pca_l >= len(refs),
          f"posegraph: {pca_l} radius_pca launches for {len(refs)} "
          "reference keyframes")

    # the two kernels at this path's shapes, against their plain versions
    i, j = cand[0]
    rel0 = torch.from_numpy(np.linalg.inv(kf_poses[i]) @ kf_poses[j])
    moved = nt.se3.apply_points(rel0.float(), kf_pos[j])
    entries = []
    e = knn_case("loop_closure_k1", moved, kf_mask[j], kf_pos[i], kf_mask[i],
                 1, role="loop_closure")
    entries.append(e)
    m = kf_mask[i]
    c = (torch.where(m[:, None], kf_pos[i], torch.zeros_like(kf_pos[i])).sum(0)
         / m.float().sum())
    q = (kf_pos[i] - c).contiguous()
    e = pca_case("keyframe_normals", q, m, 1.0, 1024, Ws[0], on_path=True,
                 rng=rng)
    e["name"] = "radius_pca[D=3,keyframe]"
    entries.append(e)
    counts = dict(map_launch)
    counts["knn_brute[D=3,k=1,loop_closure]"] = knn_l
    counts["radius_pca[D=3,keyframe]"] = pca_l
    return counts, entries


# ---------------------------------------------------------------------------
# cli: the offline file entry point; distributed: the collective layer
# ---------------------------------------------------------------------------

CLI_FORMATS = {5: "ply", 9: "pcd", 13: "csv"}  # scan index -> format; else vtk
CLI_T0_NS = 1_700_000_000_000_000_000
CLI_SCAN_NS = 100_000_000


def rot_to_quat(R):
    """``(x, y, z, w)`` of a rotation matrix, in float64."""
    R = np.asarray(R, np.float64)
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    x = np.sqrt(max(0.0, 1 + R[0, 0] - R[1, 1] - R[2, 2])) / 2
    y = np.sqrt(max(0.0, 1 - R[0, 0] + R[1, 1] - R[2, 2])) / 2
    z = np.sqrt(max(0.0, 1 - R[0, 0] - R[1, 1] + R[2, 2])) / 2
    return (float(np.copysign(x, R[2, 1] - R[1, 2])),
            float(np.copysign(y, R[0, 2] - R[2, 0])),
            float(np.copysign(z, R[1, 0] - R[0, 1])), float(w))


def write_cli_dataset(root, scans, poses):
    """``root/scans/scan_NNN.<ext>`` (VTK, and one PLY, one binary PCD and
    one CSV) and ``root/icp_odom.csv`` (the poses as ROS-PoseStamped rows,
    0.1 s apart).  Returns the scan paths."""
    from norlab_icp_mapper_tpu_torch import io as tio
    os.makedirs(os.path.join(root, "scans"))
    paths = []
    for i, scan in enumerate(scans):
        ext = CLI_FORMATS.get(i, "vtk")
        path = os.path.join(root, "scans", f"scan_{i:03d}.{ext}")
        if ext == "pcd":
            tio.write_pcd(path, scan, binary=True)
        else:
            tio.write_point_cloud(path, scan)
        paths.append(path)
    with open(os.path.join(root, "icp_odom.csv"), "w") as f:
        f.write("header.stamp.sec,header.stamp.nanosec,"
                "pose.pose.position.x,pose.pose.position.y,"
                "pose.pose.position.z,pose.pose.orientation.x,"
                "pose.pose.orientation.y,pose.pose.orientation.z,"
                "pose.pose.orientation.w\n")
        for i, P in enumerate(poses):
            ns = CLI_T0_NS + i * CLI_SCAN_NS
            vals = [*map(float, P[:3, 3]), *rot_to_quat(P[:3, :3])]
            f.write(f"{ns // 10**9},{ns % 10**9},"
                    + ",".join(repr(v) for v in vals) + "\n")
    return paths


def parse_ms_by_format(paths, reps=5):
    """Median host ms of ``io.read_point_cloud`` on one file per format."""
    from norlab_icp_mapper_tpu_torch import io as tio
    out = {}
    for path in paths:
        ext = os.path.splitext(path)[1][1:]
        if ext in out:
            continue
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            tio.read_point_cloud(path)
            ts.append((time.perf_counter() - t0) * 1e3)
        out[ext] = statistics.median(ts)
    return out


@contextlib.contextmanager
def cli_checked(tally, state):
    """``build_map``'s Mapper and ScanLoader, instrumented: from the third
    scan on, every scan's hand-over, filters and step -- and whatever the
    loader's threads do meanwhile (the mode is process-wide) -- run under
    ``torch.cuda.set_sync_debug_mode("error")``; a scan that applies
    deferred window events or replays an overflowing merge waits by design
    and runs under ``"warn"`` (see ``no_sync``).  Also records each scan's
    map capacity, the host ms the loop waits for each scan from the loader
    (its hand-over included), and the clock at the third scan and at the
    first drain after the loop."""
    from norlab_icp_mapper_tpu_torch import build_map
    import norlab_icp_mapper_tpu_torch as nt

    class Mapper(nt.Mapper):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.caps = []
            state["mapper"] = self

        def process_input(self, *args, **kwargs):
            super().process_input(*args, **kwargs)
            self.caps.append(self.map.local.capacity)

        def drain(self):
            super().drain()
            if state.get("loop_done") and "t_drained" not in state:
                state["t_drained"] = time.perf_counter()

    class Loader(build_map.ScanLoader):
        def __init__(self, *args, **kwargs):
            if "workers" in state:  # a variant of the parse threads
                kwargs["workers"] = state["workers"]
            super().__init__(*args, **kwargs)
            state["workers_used"] = kwargs.get("workers")

        def __iter__(self):
            items = super().__iter__()
            state["loader_wait_ms"] = waits = []
            try:
                for i in range(len(self)):
                    t0 = time.perf_counter()
                    item = next(items)  # the hand-over, and any wait for it
                    waits.append((time.perf_counter() - t0) * 1e3)
                    if i >= 2:
                        m = state["mapper"]
                        window = bool(m._pending_window) \
                            or m._overflow_remerge is not None
                        if i == 2:
                            state["t_steady"] = time.perf_counter()
                        tally["scans_checked"] += 1
                        tally["waiting_scans"] += int(window)
                        torch.cuda.set_sync_debug_mode(
                            "warn" if window else "error")
                    yield item
            finally:
                torch.cuda.set_sync_debug_mode(0)
                state["loop_done"] = True

    saved = build_map.Mapper, build_map.ScanLoader
    build_map.Mapper, build_map.ScanLoader = Mapper, Loader
    try:
        yield
    finally:
        build_map.Mapper, build_map.ScanLoader = saved


def write_outputs(mapper, out_dir):
    """What ``build_map.main`` writes, from a mapper driven in memory."""
    from norlab_icp_mapper_tpu_torch import io as tio
    os.makedirs(out_dir)
    cloud = mapper.get_map()
    tio.write_vtk(os.path.join(out_dir, "map.vtk"), cloud["positions"],
                  {k: v for k, v in cloud.items() if k != "positions"})
    mapper.get_trajectory().save(os.path.join(out_dir, "trajectory.vtk"))


def phase_cli(scans, poses):
    """The 18-scan sequence written to files (VTK, one PLY, one binary PCD,
    one CSV; ``icp_odom.csv``), built into a map by ``build_map.main`` on
    the card under examples/config.yaml, steady scans under ``"error"``;
    then a Mapper fed in memory with the arrays the readers decode, without
    a drain between scans: the written map and trajectory equal bit for
    bit, and its free-running scans/s beside the CLI's."""
    import collections
    import shutil
    import tempfile
    import warnings
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch import build_map, io as tio
    from norlab_icp_mapper_tpu_torch.io import native
    config = os.path.join(HERE, "examples", "config.yaml")
    root = tempfile.mkdtemp(prefix="nim_cli_")
    try:
        t0 = time.time()
        paths = write_cli_dataset(root, scans, poses)
        write_s = time.time() - t0
        parse_ms = parse_ms_by_format(paths)
        tally, state = collections.Counter(), {}
        reset_counts()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            with cli_checked(tally, state):
                cli, per_scan = build_map.main(
                    root, config, os.path.join(root, "cli"), verbose=False,
                    device="cuda")
        launches = read_counts()
        tally["waiting_scan_syncs"] = sum("synchroniz" in str(w.message)
                                          for w in caught)
        n = len(paths)
        cli_rate = (n - 2) / (state["t_drained"] - state["t_steady"])
        # the same run with fewer parse threads (the interpreter lock is
        # shared by the loop and the loader's threads)
        variants = {}
        for workers in (1, 4):
            v_state = {"workers": workers}
            with cli_checked(collections.Counter(), v_state):
                build_map.main(root, config,
                               os.path.join(root, f"cli_w{workers}"),
                               verbose=False, device="cuda")
            variants[f"workers_{workers}"] = {
                "cli_steady_scans_per_s": (n - 2) / (
                    v_state["t_drained"] - v_state["t_steady"]),
                "loader_wait_ms_steady_total": sum(
                    v_state["loader_wait_ms"][2:])}

        # the same scans in memory: the arrays the readers decode, uploaded
        # before the loop, fed as the CLI feeds them
        traj = tio.read_trajectory_csv(os.path.join(root, "icp_odom.csv"))
        decoded = [tio.read_point_cloud(p) for p in paths]
        mem = nt.Mapper(config, is_3d=True, is_online=False, is_mapping=True,
                        save_map_cells_on_hard_drive=False, device="cuda")
        batches = [nt.PointBatch.from_numpy(p, d, device="cuda")
                   for p, d in decoded]
        torch.cuda.synchronize()
        mem_caps = []
        for i, (b, (pos, _), (pose, stamp)) in enumerate(
                zip(batches, decoded, traj)):
            if i == 2:
                t0 = time.perf_counter()
            mem.process_input(mem.apply_input_filters(b), pose, stamp,
                              scan_valid_hint=pos.shape[0])
            mem_caps.append(mem.map.local.capacity)
        mem.drain()
        mem_rate = (n - 2) / (time.perf_counter() - t0)
        write_outputs(mem, os.path.join(root, "mem"))
        same = {}
        for name in ("map.vtk", "trajectory.vtk"):
            with open(os.path.join(root, "cli", name), "rb") as a, \
                    open(os.path.join(root, "mem", name), "rb") as b:
                same[name] = a.read() == b.read()
            for workers, v in variants.items():
                with open(os.path.join(root, "mem", name), "rb") as a, \
                        open(os.path.join(root, f"cli_w{workers[-1]}", name),
                             "rb") as b:
                    v[f"{name}_bit_identical"] = a.read() == b.read()
        got = tio.read_vtk(os.path.join(root, "cli", "map.vtk"))
        rec = {
            "phase": "cli", "config": "examples/config.yaml", "scans": n,
            "formats": {ext: sum(p.endswith(ext) for p in paths)
                        for ext in ("vtk", "ply", "pcd", "csv")},
            "native_vtk_parser": native._load() is not None,
            "write_dataset_s": write_s,
            "parse_ms_by_format": parse_ms,
            "cli_workers": state["workers_used"],
            "cli_steady_scans_per_s": cli_rate,
            "in_memory_free_running_scans_per_s": mem_rate,
            "cli_over_in_memory": cli_rate / mem_rate,
            "cli_host_ms_per_scan": [round(t * 1e3, 2) for t in per_scan],
            "cli_host_ms_steady_median": statistics.median(per_scan[2:]) * 1e3,
            "loader_wait_ms_per_scan": [round(t, 2)
                                        for t in state["loader_wait_ms"]],
            "loader_wait_ms_steady_total": sum(state["loader_wait_ms"][2:]),
            "sync_check": dict(tally), "mapper_waits": dict(cli.waits),
            "map_points": int(got[0].shape[0]),
            "map_capacity_per_scan_cli": cli.caps,
            "map_capacity_per_scan_in_memory": mem_caps,
            "bit_identical": same, "launches": launches,
            "cli_parse_thread_variants": variants,
        }
        emit(rec)
        mem.shutdown()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    check(tally["scans_checked"] == n - 2,
          f"cli: {dict(tally)} (not every steady scan was checked)")
    check(all(same.values()),
          f"cli: the CLI's outputs differ from the in-memory drive's: {same}"
          f" (capacities {cli.caps} against {mem_caps})")
    check_map_size("cli", rec["map_points"], IDENTITY_MAP_POINTS)
    check(launches.get("sweep_knn[D=3,k=1]", 0) > 0
          and launches.get("sweep_knn[D=2,k=1]", 0) > 0
          and launches["radius_pca[D=3]"] > 0,
          f"cli: a kernel of the path was never launched: {launches}")
    return launches


def free_port() -> int:
    import socket
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# the reading's error: translation (m), then rotation (rad) -- 5 cm and 2.3
# degrees in norm
DIST_XI = np.array([0.04, -0.03, 0.02, 0.01, -0.015, 0.035], np.float32)
DIST_MAX_DIST = 1.0
DIST_MAX_ITER = 15
DIST_CPU_STRIDE = 24  # the CPU call reads every 24th ray (2,048 points)


def dist_engine_configs():
    """The single-device engine set up as ``DistributedICP`` solves:
    point-to-plane, a counter of ``DIST_MAX_ITER``, 1-NN within
    ``DIST_MAX_DIST`` -- as an unbounded brute-force matcher with a
    ``MaxDistOutlierFilter`` (exact), and as the bounded sweep matcher."""
    base = {"errorMinimizer": "PointToPlaneErrorMinimizer",
            "transformationCheckers": [{"CounterTransformationChecker": {
                "maxIterationCount": DIST_MAX_ITER}}]}
    return {
        "brute_force_maxdist_filter": dict(
            base, matcher={"KDTreeMatcher": {"knn": 1}},
            outlierFilters=[{"MaxDistOutlierFilter": {
                "maxDist": DIST_MAX_DIST}}]),
        "sweep_matcher_maxdist": dict(
            base, matcher={"KDTreeMatcher": {"knn": 1,
                                             "maxDist": DIST_MAX_DIST}}),
    }


def group_env(port):
    """torchrun's variables for a one-rank group on this host."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      WORLD_SIZE="1", RANK="0")


def phase_distributed(id_mapper, scans, poses):
    """``DistributedICP`` on a one-rank NCCL group (``multihost.initialize``
    from torchrun's variables, ``make_mesh``): the identity phase's map with
    its normals through ``shard_points(n_shards=1)``, one 49,152-ray scan
    moved by ``DIST_XI``.  Gates: the error undone within 5e-3; within 1e-4
    of the single-device engine on the card (``dist_engine_configs``,
    matches recomputed every iteration); within
    1e-5 of the same call on a one-rank gloo group on the CPU (at every
    ``DIST_CPU_STRIDE``-th ray: the plain search takes about a minute per
    iteration on the CPU at full width); no blocking read; ``knn_brute`` at
    this shape against its plain version.  The groups are destroyed."""
    import torch.distributed as dist
    from norlab_icp_mapper_tpu_torch import se3
    from norlab_icp_mapper_tpu_torch.icp.engine import ICPEngine
    from norlab_icp_mapper_tpu_torch.ops.nn import knn
    from norlab_icp_mapper_tpu_torch.parallel import (
        DistributedICP, make_mesh, multihost, shard_points)
    from norlab_icp_mapper_tpu_torch.points import PointBatch
    env_before = {k: os.environ.get(k) for k in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK",
        "NIM_TPU_REMATCH_EVERY")}
    m = id_mapper.get_map()
    mp, mn, mm = shard_points(m["positions"], m["normals"],
                              np.ones(m["positions"].shape[0], bool), 1)
    T_err = se3.exp_se3(torch.from_numpy(DIST_XI)).numpy()
    k = len(scans) // 2
    world = scans[k] @ poses[k][:3, :3].T + poses[k][:3, 3]
    moved = (world @ T_err[:3, :3].T + T_err[:3, 3]).astype(np.float32)
    n_read = moved.shape[0]
    try:
        group_env(free_port())
        multihost.initialize()
        mesh = make_mesh()
        backend = dist.get_backend()
        blocks = [multihost.make_global_array(a, mesh) for a in (mp, mn, mm)]
        read = torch.from_numpy(moved).cuda()
        rmask = torch.ones(n_read, dtype=torch.bool, device="cuda")
        icp = DistributedICP(mesh, max_dist=DIST_MAX_DIST,
                             max_iter=DIST_MAX_ITER)
        icp.solve(read, rmask, *blocks)  # warm-up: communicator, kernels
        torch.cuda.synchronize()
        before = knn.launches_by_shape.get((3, 1), 0)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.set_sync_debug_mode("error")
        try:
            a.record()
            T, overlap, rms = icp.solve(read, rmask, *blocks)
            b.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches = knn.launches_by_shape.get((3, 1), 0) - before
        first_ms = a.elapsed_time(b)
        solve_ms = time_cuda(lambda: icp.solve(read, rmask, *blocks), reps=5)
        T_card = T.cpu().numpy()
        # the same reading through the single-device engine on the card,
        # matches recomputed every iteration: 1-NN by the brute-force
        # search, pairs beyond maxDist given weight 0 (the same function);
        # and, for the record, with the sweep matcher, whose capped windows
        # overflow on the dense hall (there it is not exact)
        os.environ["NIM_TPU_REMATCH_EVERY"] = "1"
        ref_pos, ref_nrm, ref_msk = (x[0] for x in blocks)
        engine = {}
        for form, icp_cfg in dist_engine_configs().items():
            eng = ICPEngine(icp_cfg)
            out = eng.solve(read, rmask, ref_pos, ref_nrm, ref_msk,
                            eng.build_ref_pack(PointBatch(ref_pos, ref_msk)))
            engine[form] = {
                "T_max_abs_diff": float(np.abs(out.correction.cpu().numpy()
                                               - T_card).max()),
                "iterations": int(out.iterations),
                "matcher_overflow_tiles": int(eng.last_overflow)}
        # the local search at this shape against its plain version
        p0 = se3.apply_points(T, read)
        entry = knn_case("distributed_local_nn_k1", p0, rmask, ref_pos,
                         ref_msk, 1, role="distributed")
        # the same call at a decimated reading, on the card ...
        sub = moved[::DIST_CPU_STRIDE]
        sub_mask = np.ones(sub.shape[0], bool)
        T_sub = icp.solve(sub, sub_mask, *blocks)[0].cpu().numpy()
        dist.destroy_process_group()
        # ... and on a one-rank gloo group on the CPU
        group_env(free_port())
        multihost.initialize(device="cpu")
        cpu_mesh = make_mesh()
        t0 = time.time()
        T_cpu = DistributedICP(cpu_mesh, max_dist=DIST_MAX_DIST,
                               max_iter=DIST_MAX_ITER).solve(
            sub, sub_mask, mp, mn, mm)[0].numpy()
        cpu_s = time.time() - t0
        dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, v in env_before.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
    err = float(np.abs(T_card @ T_err - np.eye(4)).max())
    cpu_diff = float(np.abs(T_sub - T_cpu).max())
    rec = {
        "phase": "distributed", "backend": backend,
        "world_size": 1, "mesh": str(mesh),
        "map_points": int(m["positions"].shape[0]),
        "block_capacity": int(mp.shape[1]), "reading_points": n_read,
        "T_err_xi": DIST_XI.tolist(), "max_dist": DIST_MAX_DIST,
        "max_iter": DIST_MAX_ITER,
        "T_times_T_err_minus_I_max": err, "overlap": float(overlap),
        "rms": float(rms), "solve_ms": solve_ms,
        "solve_ms_checked_run": first_ms,
        "ms_per_iteration": solve_ms / DIST_MAX_ITER,
        "knn_brute_launches": launches,
        "engine": engine,
        "cpu_reading_points": int(sub.shape[0]),
        "card_vs_cpu_T_max_abs_diff": cpu_diff, "cpu_solve_s": cpu_s,
        "blocking_reads": 0,  # the checked solve ran under "error"
    }
    emit(rec)
    check(backend == "nccl", f"distributed: backend {backend}, not NCCL")
    check(err <= 5e-3, f"distributed: T @ T_err is {err} from I (> 5e-3)")
    exact = engine["brute_force_maxdist_filter"]
    check(exact["iterations"] == DIST_MAX_ITER
          and exact["T_max_abs_diff"] <= 1e-4,
          f"distributed: not within 1e-4 of the single-device engine: "
          f"{engine}")
    check(cpu_diff <= 1e-5, f"distributed: card and CPU differ by {cpu_diff}")
    check(launches == DIST_MAX_ITER,
          f"distributed: {launches} knn_brute launches for "
          f"{DIST_MAX_ITER} iterations")
    return {entry["name"]: launches}, entry


# ---------------------------------------------------------------------------
# sharded: the per-scan mapper with its map split over the ranks of a mesh
# ---------------------------------------------------------------------------

# one rank's halo buffer: a point within 1 m of a 4.8 m cell's edge is
# about two in three of the hall's map points; 32,768 rows hold a
# two-rank block's share with room to spare
SHARDED_OPTIONS = {"halo_capacity": 32_768}
SHARDED_GATE_SCANS = 10  # scans of the drive with the insert gate


# the sharded numbers on this sequence when its solve was a Python loop of
# 40 masked iterations (NVIDIA H100 80GB HBM3, 700 W), printed beside this
# run's
MASKED_LOOP_SHARDED = {"masked_loop_step_locked_ms": 150.63,
                       "masked_loop_free_running_scans_per_s": 6.65}
SHARDED_P2POINT_SCANS = 8


def hold_sharded_graph(mapper, scan, prior):
    """One scan's sharded solve replayed from its graph against the same
    iterations run eagerly as the masked loop (``_ShardedLoop``, every
    ``max_iter`` iteration, no read), on the same card tensors and NCCL
    group: T, overlap and live iterations bit for bit.  Times both."""
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch import se3
    from norlab_icp_mapper_tpu_torch.draws import upload
    from norlab_icp_mapper_tpu_torch.parallel.sharded_map import _ShardedLoop
    sh = mapper._sharded
    step = sh.step
    b = nt.PointBatch.from_numpy(scan, capacity=SCAN_CAPACITY, device="cuda")
    filtered = mapper.apply_input_filters(b)
    scan_m = se3.apply(upload(prior, sh.device), filtered)
    read_mask = mapper.icp.reading_filters.apply(scan_m, mapper.draws).mask
    st = sh.state
    args = (scan_m.positions, read_mask, st["pos"], st["nrm"], st["msk"])
    captures = step.graph_captures
    g = step.icp_solve(*args, draws=sh.draws)
    index = sh.draws.solves - 1 if sh.cfg.step_filter is not None else 0

    def masked():
        return _ShardedLoop(step, *args, draws=sh.draws,
                            solve_index=torch.full((), index,
                                                   dtype=torch.int64,
                                                   device="cuda")).run(
            stop=False)
    loop = masked()
    same = [bool(torch.equal(a, b)) for a, b in zip(g[:3], loop[:3])]
    graph_ms = time_cuda(lambda: step.icp_solve(*args, draws=sh.draws))
    loop_ms = time_cuda(masked, reps=3, warmup=1)
    rec = {"phase": "sharded_graph_vs_masked_loop",
           "T_bit_identical": same[0], "overlap_bit_identical": same[1],
           "iterations_bit_identical": same[2],
           "iterations_live": int(g[2]),
           "iterations_on_device": sh.cfg.max_iter,
           "T_max_abs_diff": float((g[0] - loop[0]).abs().max()),
           "new_captures": step.graph_captures - captures,
           "solve_graph_ms": graph_ms, "solve_masked_loop_ms": loop_ms,
           "graph_ms_per_iteration_on_device": graph_ms / sh.cfg.max_iter}
    emit(rec)
    check(all(same), f"sharded: the solve graph differs from the masked "
                     f"loop: {rec}")
    check(0 < rec["iterations_live"] < sh.cfg.max_iter,
          f"sharded: the solve did not stop on its checkers: {rec}")
    return lambda: step.icp_solve(*args, draws=sh.draws)


def hold_sharded_step_paths(mapper, scan, prior):
    """The sharded solve's step mask at the first matcher pass of one
    scan's solve (``_ShardedLoop`` started, the reading sorted by the
    sweep) both ways on the card: the solve's path (a row-local chain,
    ``rows=order``) against the permute path (through the inverse of the
    sort), bit for bit.  Returns one call of each, for their launches, and
    one replay of the scan's solve graph."""
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch import se3
    from norlab_icp_mapper_tpu_torch.draws import upload
    from norlab_icp_mapper_tpu_torch.icp.engine import _invert
    from norlab_icp_mapper_tpu_torch.parallel.sharded_map import _ShardedLoop
    sh = mapper._sharded
    step = sh.step
    b = nt.PointBatch.from_numpy(scan, capacity=SCAN_CAPACITY, device="cuda")
    scan_m = se3.apply(upload(prior, sh.device),
                       mapper.apply_input_filters(b))
    read_mask = mapper.icp.reading_filters.apply(scan_m, mapper.draws).mask
    st = sh.state
    loop = _ShardedLoop(step, scan_m.positions, read_mask, st["pos"],
                        st["nrm"], st["msk"], draws=sh.draws,
                        solve_index=torch.full((), sh.draws.solves,
                                               dtype=torch.int64,
                                               device="cuda"))
    loop.start()
    p = se3.apply_points(loop.T, loop.read)
    inv = _invert(loop.order)

    def solve_path():
        return step._step_mask(p, loop.mask, loop._draws(), loop.order,
                               loop.inv_order)

    def permuted():
        return step._step_mask_permuted(p, loop.mask, loop._draws(),
                                        loop.order, inv)
    got, want = solve_path(), permuted()
    rec = {"phase": "sharded_step_paths", "sorted": loop.order is not None,
           "inverse_built": loop.inv_order is not None,
           "mask_bit_identical": bool(torch.equal(got, want)),
           "kept": int(got.sum()), "valid": int(loop.mask.sum())}
    emit(rec)
    check(rec["mask_bit_identical"] and rec["sorted"]
          and not rec["inverse_built"],
          f"sharded: the solve's step mask differs from the permute path: "
          f"{rec}")
    check(0 < rec["kept"] < rec["valid"],
          f"sharded: the step mask kept {rec['kept']} of {rec['valid']}")
    args = (scan_m.positions, read_mask, st["pos"], st["nrm"], st["msk"])
    return solve_path, permuted, lambda: step.icp_solve(*args,
                                                        draws=sh.draws)


def sharded_config(name="config_p2plane.yaml", point_distance=False,
                   unbounded=False, static=False, p2point=False, step=False):
    """A bundled config as a dict; ``point_distance`` puts a
    PointDistanceMapperModule (0.15 m) first in the module list,
    ``unbounded`` drops the matcher's maxDist (the brute-force 1-NN),
    ``static`` drops DynamicPoints and the cut at its threshold: then no
    voxel once occupied is emptied, and the occupied voxels do not depend
    on which point represents a voxel (that follows the layout: the random
    draws are the rank's, the first point is the block's first slot);
    ``p2point`` swaps in the point-to-point solve of the CPU tests (1-NN
    within 1 m, trimmed 0.9, 15 iterations); ``step`` adds a random step
    filter (prob 0.9)."""
    import yaml
    with open(os.path.join(HERE, "examples", name)) as fh:
        cfg = yaml.safe_load(fh)
    if point_distance:
        cfg["mapper"]["mapperModule"].insert(0, {
            "PointDistanceMapperModule": {"minDistNewPoint": 0.15}})
    if unbounded:
        cfg["icp"]["matcher"]["KDTreeMatcher"].pop("maxDist")
    if p2point:
        # tests/test_torch_sharded_mapper.py's point-to-point solve
        cfg["icp"].update({
            "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 1.0}},
            "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.9}}],
            "errorMinimizer": "PointToPointErrorMinimizer",
            "transformationCheckers": [{"CounterTransformationChecker": {
                "maxIterationCount": 15}}]})
    if step:
        cfg["icp"]["readingStepDataPointsFilters"] = [
            {"RandomSamplingDataPointsFilter": {"prob": STEP_PROB}}]
    if static:
        cfg["mapper"]["mapperModule"] = [
            m for m in cfg["mapper"]["mapperModule"]
            if "DynamicPointsMapperModule" not in m]
        cfg["post"] = [f for f in cfg["post"] if
                       "CutAtDescriptorThresholdDataPointsFilter" not in f]
    return cfg


def sweep_roles(tally):
    """Wrap the sharded module's ``sweep_knn`` so that the launches made
    inside it are added to ``tally`` by role (the radius tells insert gate
    and angular 1-NN apart); the wrapper's own counter is read before and
    after every call.  The matcher runs inside the solve's graph, whose
    replays add to the wrapper's counter without a call: its role is the
    rest of the D=3 k=1 launches (``sharded_drive``).  Returns the undo."""
    from norlab_icp_mapper_tpu_torch.ops import nn_sweep as S
    from norlab_icp_mapper_tpu_torch.parallel import sharded_map as SM
    inner = SM.sweep_knn

    def counted(*args, **kwargs):
        before = S.sweep_knn.launches
        out = inner(*args, **kwargs)
        r = kwargs["max_radius"]
        role = ("insert_gate" if r == 0.15 else
                "angular" if r < 0.1 else "matcher")
        if role != "matcher":  # the matcher runs in the solve's graph
            tally[role] += S.sweep_knn.launches - before
        return out
    SM.sweep_knn = counted

    def undo():
        SM.sweep_knn = inner
    return undo


def sharded_drive(mesh, config, scans, priors, strict, free=False):
    """A sharded Mapper (``Mapper(config, mesh=mesh)``) over the sequence:
    drained after every scan, or (``free``) only at the end.  ``strict``
    runs each steady scan's filters and step under
    ``set_sync_debug_mode("error")`` (every read the mapper makes waits on
    an event and is counted in its ``waits``, by scan)."""
    import collections
    import norlab_icp_mapper_tpu_torch as nt
    mapper = nt.Mapper(config, is_3d=True, device="cuda", seed=0, mesh=mesh,
                       sharded_options=SHARDED_OPTIONS)
    batches = [nt.PointBatch.from_numpy(s, capacity=SCAN_CAPACITY,
                                        device="cuda") for s in scans]
    roles = collections.Counter()
    undo = sweep_roles(roles)
    reset_counts()
    per_scan, iters, step_reads = [], [], []
    log = mapper._sharded.read_log
    try:
        t_free = None
        for i, (b, prior) in enumerate(zip(batches, priors)):
            if free and i == 2:
                mapper.drain()
                torch.cuda.synchronize()
                t_free = time.time()
            t0 = time.time()
            torch.cuda.set_sync_debug_mode("error" if strict and i >= 2
                                           else 0)
            n_log = len(log)
            try:
                filtered = mapper.apply_input_filters(b)
                mapper.process_input(filtered, prior, int(i * 1e8))
            finally:
                torch.cuda.set_sync_debug_mode(0)
            if i >= 2:
                step_reads += [f"{i}:{cause}" for _, cause in log[n_log:]]
            if not free:
                mapper.drain()
                torch.cuda.synchronize()
            per_scan.append((time.time() - t0) * 1e3)
            if not free and i > 0:
                iters.append(int(mapper.last_iterations))
        mapper.drain()
        torch.cuda.synchronize()
        t_end = time.time()
    finally:
        undo()
    launches = read_counts()
    roles["matcher"] = (launches.get("sweep_knn[D=3,k=1]", 0)
                        - roles.get("insert_gate", 0))
    sh = mapper._sharded
    reads = collections.Counter(
        f"{i}:{cause}" for i, cause in sh.read_log
        if cause not in ("drain", "get_pose"))
    m = mapper.get_map()
    rec = {
        "scans": len(scans), "launches": launches,
        "sweep_launches_by_role": dict(roles),
        "final_map_count": int(m["positions"].shape[0]),
        "block_capacity": sh.capacity(),
        "overflow_totals": dict(sh.overflow_totals),
        "reads_by_scan_and_cause": dict(reads),
        # the counted reads the steady scans' process_input made (a drain
        # after a scan waits for its solve by design, and is not counted)
        "reads_in_steady_process_input": step_reads,
        "waits": dict(sh.waits),
        "per_scan_ms": [round(v, 2) for v in per_scan],
        "solve_graph_captures": sh.step.graph_captures,
    }
    if iters:
        rec["icp_iterations_live"] = iters
        rec["mean_icp_iterations_live"] = statistics.mean(iters)
    if free:
        rec["free_running_scans_per_s"] = (len(scans) - 2) / (t_end - t_free)
    else:
        rec["steady_ms_per_scan"] = statistics.mean(per_scan[2:])
        rec["scans_per_s"] = 1e3 / rec["steady_ms_per_scan"]
    return mapper, m, rec


def sharded_rank(rank, world, port, out_dir, job):
    """One rank of the two-rank run on one card: gloo carries CUDA tensors
    (NCCL refuses two ranks on one card).  Probes the collectives the
    package uses, then drives each config of ``job`` drained after every
    scan, timing the reductions inside the ICP solve."""
    import torch.distributed as dist
    import norlab_icp_mapper_tpu_torch as nt
    from norlab_icp_mapper_tpu_torch.parallel import (make_mesh, multihost,
                                                      sharded_map as SM)
    torch.cuda.set_device(0)
    multihost.initialize(f"127.0.0.1:{port}", world, rank, device="cpu")
    out = {}
    try:
        dev = torch.device("cuda", 0)
        probe = {}
        for name, op in (("all_reduce_sum", dist.ReduceOp.SUM),
                         ("all_reduce_min", dist.ReduceOp.MIN),
                         ("all_reduce_max", dist.ReduceOp.MAX)):
            t = torch.full((4,), float(rank + 1), device=dev)
            dist.all_reduce(t, op=op)
            probe[name] = t.cpu().tolist()
        parts = [torch.empty(3, device=dev) for _ in range(world)]
        dist.all_gather(parts, torch.full((3,), float(rank), device=dev))
        probe["all_gather_list"] = [p.cpu().tolist() for p in parts]
        t = torch.full((2,), float(rank), device=dev)
        dist.broadcast(t, src=1)
        probe["broadcast"] = t.cpu().tolist()
        out["probe"] = probe
        mesh = make_mesh(world)
        clock = {"solve_reduce_s": 0.0, "solve_reductions": 0,
                 "solve_s": 0.0, "gather_s": 0.0, "gather_bytes": 0}
        red, gat, solve, merge = (SM.ShardedMapperStep._reduce,
                                  SM.ShardedMapperStep._gather,
                                  SM.ShardedMapperStep.icp_solve,
                                  SM.ShardedMapperStep.merge)
        in_solve, in_merge = [False], [False]

        def timed_reduce(self, t, op):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = red(self, t, op)
            torch.cuda.synchronize()
            if in_solve[0]:
                clock["solve_reduce_s"] += time.perf_counter() - t0
                clock["solve_reductions"] += 1
            return r

        def timed_gather(self, t):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = gat(self, t)
            torch.cuda.synchronize()
            if in_merge[0]:  # the halo's gathers
                clock["gather_s"] += time.perf_counter() - t0
                clock["gather_bytes"] += r.numel() * r.element_size()
            return r

        def timed_merge(self, *a, **k):
            in_merge[0] = True
            try:
                return merge(self, *a, **k)
            finally:
                in_merge[0] = False

        def timed_solve(self, *a, **k):
            in_solve[0] = True
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                r = solve(self, *a, **k)
                torch.cuda.synchronize()
                return r
            finally:
                clock["solve_s"] += time.perf_counter() - t0
                in_solve[0] = False
        SM.ShardedMapperStep._reduce = timed_reduce
        SM.ShardedMapperStep._gather = timed_gather
        SM.ShardedMapperStep.icp_solve = timed_solve
        SM.ShardedMapperStep.merge = timed_merge
        for name, config in job["configs"]:
            for k in clock:
                clock[k] = 0
            mapper = nt.Mapper(config, is_3d=True, device="cuda", seed=0,
                               mesh=mesh, sharded_options=SHARDED_OPTIONS)
            t0 = time.time()
            for i, (s, prior) in enumerate(zip(job["scans"], job[name])):
                b = nt.PointBatch.from_numpy(s, capacity=SCAN_CAPACITY,
                                             device=dev)
                mapper.process_input(mapper.apply_input_filters(b), prior,
                                     int(i * 1e8))
                mapper.drain()
            torch.cuda.synchronize()
            sh = mapper._sharded
            g = mapper.get_map()
            np.savez(os.path.join(out_dir, f"{name}_rank{rank}.npz"),
                     poses=np.stack(mapper.get_trajectory().poses),
                     positions=g["positions"], table=sh.table_np,
                     window=np.asarray(sh.window.w),
                     cells=np.asarray(sorted(
                         sh.cell_manager.get_all_cell_ids()), dtype=str),
                     seconds=time.time() - t0,
                     halo_overflow=sh.overflow_totals["halo"],
                     insert_overflow=sh.overflow_totals["insert"],
                     merges=sh._merges, max_iter=sh.cfg.max_iter,
                     block_capacity=sh.capacity(),
                     halo_capacity=sh.cfg.halo_capacity,
                     **{k: v for k, v in clock.items()})
        np.savez(os.path.join(out_dir, f"probe_rank{rank}.npz"),
                 probe=json.dumps(probe))
    finally:
        dist.destroy_process_group()


def sharded_two_ranks(scans, poses, priors):
    """The identity and point-to-plane configs on two gloo ranks in two
    spawned processes on the one card; returns each rank's arrays."""
    import tempfile
    import torch.multiprocessing as tmp
    os.makedirs(os.path.join(HERE, "chiprun_out"), exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=os.path.join(HERE, "chiprun_out"))
    job = {"scans": scans, "identity": poses, "p2plane": priors,
           "configs": [("identity", sharded_config("config.yaml",
                                                   static=True)),
                       ("p2plane", sharded_config())]}
    t0 = time.time()
    ctx = tmp.spawn(sharded_rank, args=(2, free_port(), out_dir, job),
                    nprocs=2, join=False)
    while not ctx.join(timeout=5):
        if time.time() - t0 > 300:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            check(False, "sharded: the two gloo ranks did not finish in "
                         "300 s")
    res = {n: [dict(np.load(os.path.join(out_dir, f"{n}_rank{r}.npz")))
               for r in range(2)] for n in ("identity", "p2plane")}
    probe = json.loads(str(np.load(os.path.join(
        out_dir, "probe_rank0.npz"))["probe"]))
    return res, probe, time.time() - t0


def split_halo_case(block_pos, block_msk, cfg):
    """The halo's PCA at a two-rank layout of the final map: rank 0's block
    as queries, against itself and rank 1's near-edge points (the ghosts,
    ``halo_capacity`` rows) -- what ``merge_update`` hands ``radius_pca``
    on rank 0 of two."""
    from norlab_icp_mapper_tpu_torch.parallel import sharded_map as SM
    pos = block_pos[block_msk]
    table = SM.greedy_table(np.bincount(
        SM._bucket_np(pos.cpu().numpy(), cfg.cell_size, cfg.n_buckets),
        minlength=cfg.n_buckets), 2)
    home = torch.from_numpy(table).long().to(pos.device)[
        SM._bucket_torch(pos, cfg.cell_size, cfg.n_buckets)]
    cap = block_pos.shape[0]
    q = torch.zeros((cap, 3), device=pos.device)
    qm = torch.zeros((cap,), dtype=torch.bool, device=pos.device)
    mine = pos[home == 0]
    q[:mine.shape[0]] = mine
    qm[:mine.shape[0]] = True
    other = pos[home == 1]
    cs, r = cfg.cell_size, cfg.normal_radius
    f = other[:, :2] - torch.floor(other[:, :2] / cs) * cs
    near = ((f < r) | (f > cs - r)).any(1)
    H = cfg.halo_capacity
    ghosts = torch.zeros((2 * H, 3), device=pos.device)
    gm = torch.zeros((2 * H,), dtype=torch.bool, device=pos.device)
    g = other[near][:H]
    ghosts[H:H + g.shape[0]] = g  # rank 1's slice; rank 0's own is masked
    gm[H:H + g.shape[0]] = True
    return (q, qm, torch.cat([q, ghosts]), torch.cat([qm, gm]),
            int(near.sum()))


def sharded_pca_entry(name, query, qmask, ref, rmask, radius, q_tile, W):
    """The halo PCA's two-cloud shape: held against its plain version by
    ``pca_two_clouds_case``, then timed (launch alone, plain search) with
    its bound from this run's windows and hits."""
    from norlab_icp_mapper_tpu_torch.ops import nn_sweep as S
    from norlab_icp_mapper_tpu_torch.ops import pca as P
    pca_two_clouds_case(name, query, qmask, ref, rmask, radius, q_tile, W)
    before = P.radius_pca.launches
    r = float(np.float32(radius))
    r2 = float(np.float32(radius * radius))
    qp = S.presort_ref(query, qmask)
    rp = S.presort_ref(ref, rmask, center=qp.center)
    Wc = min(W, ref.shape[0])
    k = P._stats_kernel(qp, rp, r, r2, q_tile, Wc, 0)
    p = P._stats_plain(qp, rp, r, r2, q_tile, Wc, 0)
    err = float((k.cov - p.cov).abs().max())
    ms = time_cuda(lambda: P._stats_kernel(qp, rp, r, r2, q_tile, Wc, 0))
    plain_ms = time_cuda(lambda: P._stats_plain(qp, rp, r, r2, q_tile, Wc,
                                                0), reps=2, warmup=1)
    P.radius_pca.launches = before
    n = query.shape[0]
    n_valid = int(qmask.sum())
    hits = int(k.cnt.sum())
    # the windows the kernel walks: per block of its queries, the span of
    # sorted references, times the block's valid queries; the distance
    # test runs over every such pair, the moments over the hits
    pad = -(-n // q_tile) * q_tile - n
    qx_s = S.pad_rows(qp.ref_xs, pad, S.BIG)
    qm_s = S.pad_rows(qp.ref_mask_s, pad, False)
    r_t = torch.tensor(r, dtype=torch.float32, device=query.device)
    _, _, _, _, b_start, b_end = S.sweep_windows(
        qx_s, qm_s, rp, r_t, q_tile, Wc, P._BLOCK_QUERIES)
    per_block = qm_s.view(-1, P._BLOCK_QUERIES).sum(1)
    pairs = int(((b_end - b_start).long() * per_block).sum())
    flops = pairs * 3 * 3 + hits * (1 + 3 + 12)
    bytes_moved = (n_valid + int(rmask.sum())) * 16 + n * 4 * (1 + 3 + 9
                                                               + 3 + 3)
    ops_ms = flops / PEAK_F32_FLOPS * 1e3
    bytes_ms = bytes_moved / PEAK_BYTES * 1e3
    emit({"phase": "kernel_case", "case": f"{name}_timed",
          "kernel": "radius_pca", "N": n, "M": ref.shape[0],
          "valid_queries": n_valid, "valid_refs": int(rmask.sum()),
          "kernel_ms": ms, "plain_ms": plain_ms, "hits": hits,
          "pairs": pairs, "max_abs_err_cov": err,
          "bound_ops_ms": ops_ms, "bound_bytes_ms": bytes_ms})
    return {"name": "radius_pca[D=3,sharded_halo]", "route": "cuda",
            "source": "norlab_icp_mapper_tpu_torch/csrc/radius_pca.cu",
            "replaces": "ops/pca.py:136", "launches": 0,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


def phase_sharded(scans, poses, priors, p2_rec):
    """The sharded per-scan mapper (``Mapper(config, mesh=...)``).

    One rank over NCCL (``multihost.initialize``, ``make_mesh``): the
    point-to-plane config over the hall with the p2plane phase's priors,
    drained after every scan with the steady scans under ``"error"``, then
    free-running (also under ``"error"``); the same with a PointDistanceMapperModule (the insert
    gate's sweep); with the matcher's maxDist dropped (the brute-force
    1-NN), four scans; and the identity config without DynamicPoints and
    its cut.  Gates: ATE within max(1.5x, +2 mm) of the single-device
    port's, map within 5 % of its,
    no insert or evict overflow (the halo's is reported: on one rank the
    own slice is masked, so it cannot change a normal), every kernel of the
    path launched.  Then the kernels at the sharded shapes against their
    plain versions, and two gloo ranks in two processes on the one card:
    the identity map's occupied voxels equal one rank's, both ranks hold
    the same poses, table, window and cell ids bit for bit, and the
    collectives' time per ICP iteration and the halo's bytes per merge.
    The profiler (last) counts device launches per steady scan beside the
    single-device Mapper's."""
    import torch.distributed as dist
    from norlab_icp_mapper_tpu_torch.mapper_modules.core import \
        _spherical_angles
    from norlab_icp_mapper_tpu_torch.parallel import make_mesh, multihost
    from norlab_icp_mapper_tpu_torch import se3
    env_before = {k: os.environ.get(k) for k in (
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")}
    entries, runs = [], {}
    try:
        group_env(free_port())
        multihost.initialize()
        mesh = make_mesh()
        backend = dist.get_backend()
        mapper, m, rec = sharded_drive(mesh, sharded_config(), scans, priors,
                                       strict=True)
        est = mapper.get_trajectory().poses
        rec.update({"phase": "sharded", "drive": "p2plane_step_locked",
                    "backend": backend, "world_size": 1,
                    "recovered_ate_m": ate(est[1:], poses[1:]),
                    "single_device_ate_m": p2_rec["recovered_ate_m"],
                    "single_device_final_map_count":
                        p2_rec["final_map_count"],
                    "single_device_scans_per_s": p2_rec["scans_per_s"],
                    "single_device_free_running_scans_per_s":
                        p2_rec["free_running_scans_per_s"]})
        _, _, free = sharded_drive(mesh, sharded_config(), scans, priors,
                                   strict=True, free=True)
        rec["free_running_scans_per_s"] = free["free_running_scans_per_s"]
        # free-running, the count mirrors are read every HARVEST_EVERY
        # scans (event waits, under "error" too): where, and why
        rec["free_running_reads_by_scan_and_cause"] = \
            free["reads_by_scan_and_cause"]
        rec.update(MASKED_LOOP_SHARDED)
        emit(rec)
        main_launch = rec["launches"]
        ate_gate = max(1.5 * p2_rec["recovered_ate_m"],
                       p2_rec["recovered_ate_m"] + 0.002)
        check(not rec["reads_in_steady_process_input"],
              f"sharded: a steady step-locked scan made a counted read: "
              f"{rec['reads_in_steady_process_input']}")
        check(rec["solve_graph_captures"] >= 1
              and main_launch["graph_while"] == 0,
              f"sharded: the solve was not the unrolled graph: {rec}")
        sharded_solve = hold_sharded_graph(mapper, scans[-1], priors[-1])
        check(backend == "nccl", f"sharded: backend {backend}, not NCCL")
        check(rec["recovered_ate_m"] <= ate_gate,
              f"sharded: ATE {rec['recovered_ate_m']} m above {ate_gate}")
        n_single = p2_rec["final_map_count"]
        check(abs(rec["final_map_count"] - n_single) <= 0.05 * n_single,
              f"sharded: map of {rec['final_map_count']} points, not within "
              f"5 % of the single-device port's {n_single}")
        ov = rec["overflow_totals"]
        check(ov["insert"] == 0 and ov["evict"] == 0,
              f"sharded: insert or evict overflow: {ov}")
        check(main_launch.get("sweep_knn[D=3,k=1]", 0) > 0
              and main_launch.get("sweep_knn[D=2,k=1]", 0) > 0
              and main_launch["radius_pca[D=3]"] > 0
              and main_launch["sym_eig[D=3]"] > 0,
              f"sharded: a kernel of the path was never launched: "
              f"{main_launch}")

        # the insert gate: a PointDistanceMapperModule in front
        n_g = SHARDED_GATE_SCANS
        gmapper, gm, grec = sharded_drive(
            mesh, sharded_config(point_distance=True), scans[:n_g],
            priors[:n_g], strict=True)
        grec.update({"phase": "sharded", "drive": "p2plane_insert_gate",
                     "recovered_ate_m": ate(
                         gmapper.get_trajectory().poses[1:], poses[1:n_g])})
        emit(grec)
        check(grec["sweep_launches_by_role"].get("insert_gate", 0) > 0,
              f"sharded: the insert gate's sweep never launched: {grec}")
        check(grec["overflow_totals"]["insert"] == 0,
              "sharded: insert overflow with the gate")
        # point-to-point (the CPU tests' sharded point-to-point config at
        # the hall's size): Kabsch on the card, no counted read
        n_p = SHARDED_P2POINT_SCANS
        pmapper, _, prec = sharded_drive(
            mesh, sharded_config(p2point=True), scans[:n_p], priors[:n_p],
            strict=True)
        prec.update({"phase": "sharded", "drive": "p2point",
                     "prior_ate_m": ate(priors[1:n_p], poses[1:n_p]),
                     "recovered_ate_m": ate(
                         pmapper.get_trajectory().poses[1:], poses[1:n_p])})
        emit(prec)
        check(not prec["reads_in_steady_process_input"],
              f"sharded p2point: a steady scan made a counted read: "
              f"{prec['reads_in_steady_process_input']}")
        check("point_to_point" not in prec["waits"],
              f"sharded p2point: the moments went to the host: {prec}")
        check(prec["launches"]["kabsch"] >= n_p - 1
              and prec["launches"]["p2p_step"] >= n_p - 1,
              f"sharded p2point: the moments or the solve not on the card: "
              f"{prec['launches']}")
        # the same with a random step filter: its keep mask one
        # philox_keep launch per matcher pass on the sorted reading
        smapper, _, srec = sharded_drive(
            mesh, sharded_config(p2point=True, step=True), scans[:n_p],
            priors[:n_p], strict=True)
        srec.update({"phase": "sharded", "drive": "p2point_step",
                     "prior_ate_m": ate(priors[1:n_p], poses[1:n_p]),
                     "recovered_ate_m": ate(
                         smapper.get_trajectory().poses[1:], poses[1:n_p])})
        emit(srec)
        check(not srec["reads_in_steady_process_input"],
              f"sharded p2point_step: a steady scan made a counted read: "
              f"{srec['reads_in_steady_process_input']}")
        check(srec["launches"]["philox_keep"] >= n_p - 1
              and srec["launches"]["p2p_step"] >= n_p - 1,
              f"sharded p2point_step: the step mask or the solve not on the "
              f"card: {srec['launches']}")
        *step_paths, step_replay = hold_sharded_step_paths(
            smapper, scans[n_p - 1], priors[n_p - 1])
        # the unbounded matcher: knn_brute on the block
        umapper, _, urec = sharded_drive(
            mesh, sharded_config(unbounded=True), scans[:4], priors[:4],
            strict=False)
        urec.update({"phase": "sharded", "drive": "p2plane_unbounded"})
        emit(urec)
        check(urec["launches"].get("knn_brute[D=3,k=1]", 0) > 0,
              f"sharded: knn_brute never launched: {urec['launches']}")
        # identity over one rank: the layout the two-rank run must equal
        imapper, im, irec = sharded_drive(
            mesh, sharded_config("config.yaml", static=True), scans, poses,
            strict=True)
        irec.update({"phase": "sharded", "drive": "identity"})
        emit(irec)
        id_vox = {tuple(v) for v in np.floor(
            im["positions"] / np.float32(0.15)).astype(np.int64)}

        # ---- the kernels at the sharded shapes
        sh = mapper._sharded
        bpos, bmsk = sh.state["pos"], sh.state["msk"]
        k = len(scans) // 2
        sc = scans[k]
        scan_t = torch.from_numpy(sc).cuda()
        smask = torch.ones(sc.shape[0], dtype=torch.bool, device="cuda")
        pose_k = torch.from_numpy(est[k]).cuda()
        scan_m = se3.apply_points(pose_k, scan_t)
        e = sweep_case("sharded_matcher_k1", scan_m, smask, bpos, bmsk, 1,
                       2.0, 1024, 8192, 112)
        e["name"] = "sweep_knn[D=3,k=1,sharded_matcher]"
        entries.append(e)
        e = sweep_case("sharded_insert_gate", scan_m, smask, bpos, bmsk, 1,
                       0.15, 1024, 8192, 112)
        e["name"] = "sweep_knn[D=3,k=1,sharded_insert_gate]"
        entries.append(e)
        inv = se3.inverse(pose_k)
        map_s = se3.apply_points(inv, bpos)
        map_ang = _spherical_angles(map_s, torch.linalg.norm(map_s, dim=1))
        scan_ang = _spherical_angles(scan_t, torch.linalg.norm(scan_t, dim=1))
        e = sweep_case("sharded_dp_angular", map_ang, bmsk, scan_ang, smask,
                       1, 0.02, 1024, 1024, 112)
        e["name"] = "sweep_knn[D=2,k=1,sharded_angular]"
        entries.append(e)
        q, qm, ref, rm, n_near = split_halo_case(bpos, bmsk, sh.cfg)
        # rank 0 of two searches with 512-query tiles (block_q_tile)
        entries.append(sharded_pca_entry("sharded_halo_pca", q, qm, ref, rm,
                                         sh.cfg.normal_radius, 512, 2048))
        ub = umapper._sharded
        e = knn_case("sharded_unbounded_matcher", scan_m, smask,
                     ub.state["pos"], ub.state["msk"], 1, role="sharded")
        entries.append(e)
        runs = {
            "sweep_knn[D=3,k=1,sharded_matcher]":
                rec["sweep_launches_by_role"].get("matcher", 0),
            "sweep_knn[D=3,k=1,sharded_insert_gate]":
                grec["sweep_launches_by_role"].get("insert_gate", 0),
            "sweep_knn[D=2,k=1,sharded_angular]":
                rec["sweep_launches_by_role"].get("angular", 0),
            "radius_pca[D=3,sharded_halo]": main_launch["radius_pca[D=3]"],
            e["name"]: urec["launches"].get("knn_brute[D=3,k=1]", 0),
            # the eigensolve of the halo covariances
            "sym_eig[D=3]": main_launch["sym_eig[D=3]"],
            "kabsch": (prec["launches"]["kabsch"]
                       + srec["launches"]["kabsch"]),
            "p2p_step": (prec["launches"]["p2p_step"]
                         + srec["launches"]["p2p_step"]),
            "loop_commit": (main_launch["loop_commit"]
                            + prec["launches"]["loop_commit"]
                            + srec["launches"]["loop_commit"]),
            "philox_keep": srec["launches"]["philox_keep"],
        }

        # ---- two gloo ranks on the one card
        two, probe, two_s = sharded_two_ranks(scans, poses, priors)
        r0, r1 = two["p2plane"]
        same = all(np.array_equal(a[key], b[key])
                   for a, b in (two["identity"], two["p2plane"])
                   for key in ("poses", "positions", "table", "window",
                               "cells"))
        vox2 = {tuple(v) for v in np.floor(two["identity"][0]["positions"]
                                           / np.float32(0.15)).astype(
            np.int64)}
        d_pose = float(np.abs(r0["poses"] - np.stack(est)).max())
        iters = int(r0["merges"])  # one merge per scan after the first
        n_it = (len(scans) - 1) * int(r0["max_iter"])
        trec = {
            "phase": "sharded", "drive": "two_gloo_ranks_on_one_card",
            "probe": probe, "seconds": two_s,
            "ranks_bit_identical": same,
            "identity_voxels_equal_one_rank": vox2 == id_vox,
            "identity_voxels": [len(id_vox), len(vox2)],
            "p2plane_max_pose_diff_to_one_rank": d_pose,
            "p2plane_recovered_ate_m": ate(list(r0["poses"][1:]),
                                           poses[1:]),
            "p2plane_seconds_per_rank": [float(r["seconds"])
                                         for r in (r0, r1)],
            "p2plane_merges": iters,
            "halo_overflow": int(r0["halo_overflow"]),
            "halo_bytes_per_merge_per_rank":
                float(r0["gather_bytes"]) / max(iters, 1),
            "solve_reductions_per_iteration":
                float(r0["solve_reductions"]) / n_it,
            "solve_reduce_ms_per_iteration":
                1e3 * float(r0["solve_reduce_s"]) / n_it,
            "solve_ms_per_iteration": 1e3 * float(r0["solve_s"]) / n_it,
            "block_capacity": int(r0["block_capacity"]),
        }
        emit(trec)
        want = {"all_reduce_sum": [3.0] * 4, "all_reduce_min": [1.0] * 4,
                "all_reduce_max": [2.0] * 4,
                "all_gather_list": [[0.0] * 3, [1.0] * 3],
                "broadcast": [1.0, 1.0]}
        check(probe == want, f"sharded: gloo on CUDA tensors: {probe}")
        check(same, "sharded: the two ranks' replicated state differs")
        check(vox2 == id_vox, "sharded: two ranks' identity map differs from "
                              "one rank's")
        check(trec["halo_overflow"] == 0,
              "sharded: the halo overflowed on two ranks")
        check(trec["p2plane_recovered_ate_m"] <= ate_gate,
              f"sharded: two ranks' ATE {trec['p2plane_recovered_ate_m']}")

        # ---- device launches per steady scan (the profiler's hooks stay
        # with the process, so this comes last, before the profile phase)
        import norlab_icp_mapper_tpu_torch as nt
        feeds = {}
        for label, cfg_, kw in (
                ("single_device", sharded_config(), {}),
                ("p2point", {"icp": p2point_icp(False)}, {}),
                ("sharded", sharded_config(),
                 {"mesh": mesh, "sharded_options": SHARDED_OPTIONS}),
                ("sharded_p2point_step",
                 sharded_config(p2point=True, step=True),
                 {"mesh": mesh, "sharded_options": SHARDED_OPTIONS})):
            mm = nt.Mapper(cfg_, is_3d=True, device="cuda", seed=0, **kw)
            it = iter(range(len(scans)))

            def feed(mm=mm, it=it):
                i = next(it)
                b = nt.PointBatch.from_numpy(scans[i], capacity=SCAN_CAPACITY,
                                             device="cuda")
                mm.process_input(mm.apply_input_filters(b), priors[i],
                                 int(i * 1e8))
                mm.drain()
            for _ in range(3):
                feed()
            feeds[label] = count_device_launches(feed)
            if label != "sharded_p2point_step":
                mm.shutdown()
        SHARDED_STEP_PASS.update({
            path: count_device_launches(fn)
            for path, fn in zip(("solve", "permuted"), step_paths)})
        emit({"phase": "sharded", "drive": "device_launches_per_scan",
              "counted_by": "torch.profiler device events, one steady scan "
                            "drained (the fourth and fifth scans)",
              "single_device_and_p2point_unsharded": True, **feeds})
        prof = solve_device_profile(
            sharded_solve, iterations=mapper._sharded.cfg.max_iter)
        emit({"phase": "sharded", "drive": "solve_graph_device",
              "counted_by": "CUDA events and torch.profiler around one "
                            "replay of the last scan's solve graph; per "
                            "device iteration (all max_iter, the masked "
                            "tail included)",
              **(prof or {})})
        SHARDED_SOLVE.update(prof or {})
        SHARDED_SOLVE["steady_scan_device_launches"] = dict(feeds)
        check(prof is not None and "loop_commit" in prof["kernels"],
              f"sharded: no commit kernel in the solve graph's replay: "
              f"{prof}")
        # the point-to-point step drive's last solve graph: the increment
        # from the reduced moments and the step mask inside the replay
        sprof = solve_device_profile(
            step_replay, iterations=smapper._sharded.cfg.max_iter)
        emit({"phase": "sharded", "drive": "p2point_step_solve_graph_device",
              "counted_by": "as solve_graph_device", **(sprof or {})})
        SHARDED_STEP_SOLVE.update(sprof or {})
        check(sprof is not None and "kabsch" in sprof["kernels"]
              and "philox_keep" in sprof["kernels"],
              f"sharded p2point_step: the increment or the step mask not in "
              f"the solve graph's replay: {sprof}")
        # NCCL destroys no communicator while a graph that captured its
        # collectives lives: every sharded mapper frees its solve graphs
        for m_ in (mapper, gmapper, pmapper, umapper, imapper, smapper,
                   mm):
            m_.shutdown()
        dist.destroy_process_group()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for key, v in env_before.items():
            if v is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = v
    return runs, entries


def step_chain_launches(device_launches, feeds):
    """The step chain's device launches per matcher pass (the solve's path
    and the permute path, on the first pass of each held phase's last
    solve) and the device launches per steady scan of the drives with step
    filters, counted by ``torch.profiler``; the solve's path of a
    RandomSampling chain is one ``philox_keep`` launch."""
    per_pass = {"sharded_p2point_step": dict(SHARDED_STEP_PASS)}
    per_scan = {"p2point": feeds.get("p2point"),
                "sharded_p2point_step": feeds.get("sharded_p2point_step")}
    for key in list(device_launches):
        kind, _, rest = key.partition("/")
        if kind == "step_pass":
            phase, _, path = rest.partition("/")
            per_pass.setdefault(phase, {})[path] = device_launches.pop(key)
        elif kind == "steady_scan":
            per_scan[rest] = device_launches.pop(key)
    emit({"phase": "step_chain_launches",
          "counted_by": "torch.profiler device events: one call of each "
                        "path on the first matcher pass of the phase's "
                        "last solve; one steady scan, drained",
          "per_matcher_pass": per_pass, "per_steady_scan": per_scan})
    for phase in ("p2plane_step", "p2point", "sharded_p2point_step"):
        check(per_pass.get(phase, {}).get("solve") == 1,
              f"{phase}: the step chain took {per_pass.get(phase)} device "
              f"launches per pass, not one philox_keep")
    for phase in ("p2plane_step", "sharded_p2point_step"):
        r = per_pass[phase]
        check(r.get("permuted") is not None and r["permuted"] > r["solve"],
              f"{phase}: the permute path took no more launches than the "
              f"solve's: {r}")


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
    mapper, rec = drive("config.yaml", scans, poses, "identity", strict=True)
    id_mapper = mapper  # its map feeds the distributed phase
    _, free = free_running("config.yaml", scans, poses)
    rec.update(free)
    emit(rec)
    check_map(mapper, rec, len(scans))
    check_sync(rec)
    check_map_size("identity_free_running",
                   rec["free_running_final_map_count"], IDENTITY_MAP_POINTS)
    id_launch = rec["launches"]
    check(id_launch.get("sweep_knn[D=3,k=1]", 0) > 0
          and id_launch.get("sweep_knn[D=2,k=1]", 0) > 0
          and id_launch["radius_pca[D=3]"] > 0,
          f"identity: a kernel of the path was never launched: {id_launch}")
    check(id_launch["radius_pca[D=3]"] == len(scans),
          "identity: the SurfaceNormal filter is not one launch per scan: "
          f"{id_launch}")
    check_graph_launches("identity", id_launch, len(scans))
    check_map_size("identity", rec["final_map_count"], IDENTITY_MAP_POINTS)
    identity_map_count = rec["final_map_count"]

    # ---- p2plane: perturbed priors, the first pose anchors the map
    rng = np.random.default_rng(args.seed + 1)
    priors = [poses[0]] + [perturb(p, rng) for p in poses[1:]]
    mapper, rec = drive("config_p2plane.yaml", scans, priors, "p2plane",
                        strict=True)
    p2_mapper = mapper
    free_mapper, free = free_running("config_p2plane.yaml", scans, priors)
    rec.update(free)
    rec["free_running_recovered_ate_m"] = ate(
        free_mapper.get_trajectory().poses[1:], poses[1:])
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
    p2_rec = rec
    emit(rec)
    check_map(mapper, rec, len(scans))
    check(rec_ate < prior_ate / 3.0,
          f"p2plane: recovered ATE {rec_ate} not below a third of the "
          f"prior's {prior_ate}")
    check(rec_ate <= 0.004, f"p2plane: recovered ATE {rec_ate} m > 0.004 m")
    check(abs(statistics.mean(its) - P2PLANE_ITERATIONS) <= 1.0,
          f"p2plane: {statistics.mean(its)} iterations per scan, not within "
          f"1 of {P2PLANE_ITERATIONS}")
    check_map_size("p2plane", rec["final_map_count"], P2PLANE_MAP_POINTS)
    check(p2_launch.get("sweep_knn[D=3,k=3]", 0) > 0
          and p2_launch.get("sweep_knn[D=2,k=1]", 0) > 0
          and p2_launch["radius_pca[D=3]"] > 0,
          f"p2plane: a kernel of the path was never launched: {p2_launch}")
    check_sync(rec)
    check_graph_launches("p2plane", p2_launch, len(scans))
    check(rec["free_running_recovered_ate_m"] <= 0.004,
          "p2plane: the free-running run's ATE is "
          f"{rec['free_running_recovered_ate_m']} m")
    check_map_size("p2plane_free_running",
                   rec["free_running_final_map_count"], P2PLANE_MAP_POINTS)
    hold_graph_solve(p2_mapper, "p2plane")

    # ---- tracing: the same drive with the overflow sink installed
    tr_launch = phase_tracing(scans, priors)
    # ---- checkpoint: the point-to-plane map saved, loaded, localized in
    phase_checkpoint(p2_mapper, scans, priors)

    # ---- online: the point-to-plane config with is_online=True, without a
    # drain between scans, against the offline free-running run
    online, orec = free_running("config_p2plane.yaml", scans, priors,
                                online=True)
    on_est = online.get_trajectory().poses
    off_est = free_mapper.get_trajectory().poses
    dt = max(float(np.linalg.norm(a[:3, 3] - b[:3, 3]))
             for a, b in zip(on_est, off_est))
    waits = orec["get_pose_wait_ms"]
    orec.update({
        "phase": "online", "config": "examples/config_p2plane.yaml",
        "recovered_ate_m": ate(on_est[1:], poses[1:]),
        "max_pose_translation_diff_to_offline_m": dt,
        "final_map_count": orec["free_running_final_map_count"],
        "offline_final_map_count": free["free_running_final_map_count"],
        "get_pose_wait_ms_median": statistics.median(waits),
        "get_pose_wait_ms_max": max(waits),
        "graph_captures": online.icp.graph_captures})
    emit(orec)
    # a scan harvested earlier or later can change the buffer's capacity,
    # and with it the octree's random draws (one per slot): representatives
    # and, through the reading, poses may move by about the ICP's accuracy
    check(len(on_est) == len(scans), "online: trajectory length")
    check(dt <= 0.005, f"online: a pose differs from the offline run's by "
          f"{dt} m (> 5 mm)")
    check(orec["recovered_ate_m"] <= 0.004,
          f"online: recovered ATE {orec['recovered_ate_m']} m > 0.004 m")
    check(abs(orec["final_map_count"] - orec["offline_final_map_count"])
          <= 0.01 * orec["offline_final_map_count"],
          "online: the map differs from the offline run's by more than 1 %")
    online.shutdown()

    # ---- default: no config at all, the same perturbed priors
    mapper, rec, last_merge = drive_default(scans, priors)
    df_launch = rec["launches"]
    _, free = free_running(None, scans, priors)
    rec.update(free)
    finish_no_radius_phase(mapper, rec, priors, poses)
    check_map_size("default", rec["final_map_count"], DEFAULT_MAP_POINTS)
    check_graph_launches("default", df_launch, len(scans))
    hold_graph_solve(mapper, "default")
    check(rec["merges"] >= 3, f"default: {rec['merges']} merges")
    check(rec["map_capacity"] > MAP_CAPACITY,
          f"default: the map buffer stayed at {rec['map_capacity']}")
    check(last_merge is not None, "default: no merge after the first scan")
    check_last_merge(mapper, last_merge)

    # ---- p2point: the rest of the ICP engine on the card, a few scans.
    # Fused path first; then the same with a bound checker, which sends
    # the scans through the stepwise path (its throw happens on the host)
    # (every solve one graph replay: Kabsch and the step filter's draws on
    # the card; the steady solves make no synchronising call)
    n_pp = 6
    mapper, rec, _ = drive_default(scans[:n_pp], priors[:n_pp],
                                   {"icp": p2point_icp(False)}, "p2point",
                                   strict_solve=True)
    pp_launch = rec["launches"]
    pp_rec = rec
    finish_no_radius_phase(mapper, rec, priors, poses)
    check_solve_sync(rec)
    check_graph_launches("p2point", pp_launch, n_pp)
    check(pp_launch["p2p_step"] >= sum(rec["icp_iterations"][1:])
          and pp_launch["loop_commit"] >= sum(rec["icp_iterations"][1:])
          and pp_launch["philox_keep"] > 0,
          f"p2point: the minimizer, the commit or the step draws not on "
          f"the card: {pp_launch}")
    hold_step_paths("p2point", hold_graph_solve(mapper, "p2point"))
    mapper, rec, _ = drive_default(scans[:4], priors[:4],
                                   {"icp": p2point_icp(True)},
                                   "p2point_bound", strict_solve=True)
    finish_no_radius_phase(mapper, rec, priors, poses)
    check_solve_sync(rec)
    check_graph_launches("p2point_bound", rec["launches"], 4)
    hold_graph_solve(mapper, "p2point_bound")

    # ---- step filters with maxDist: the p2plane config with a random step
    # filter, its draws keyed on the card inside the solve graph
    st_launch, so_launch = phase_step_filters(scans, priors, poses)

    # ---- octree leaves with maxPointByNode > 1, the filter zoo, keyframes
    # and the pose graph
    ok_launch = phase_octree_k(scans, poses, args.seed, identity_map_count)
    phase_filters(scans, args.seed)
    fl_launch = phase_filters_drive(scans, poses)
    pg_launch, pg_entries = phase_posegraph(args.seed, rng)
    entries += pg_entries

    # ---- the offline file entry point, and DistributedICP on a one-rank
    # NCCL group
    cli_launch = phase_cli(scans, poses)
    ds_launch, ds_entry = phase_distributed(id_mapper, scans, poses)
    entries.append(ds_entry)
    # ---- the sharded per-scan mapper (one NCCL rank; two gloo ranks)
    sh_launch, sh_entries = phase_sharded(scans, poses, priors, p2_rec)
    entries += sh_entries

    prof = phase_profile()
    solve_dev = prof["solve_device"]
    feeds = SHARDED_SOLVE.get("steady_scan_device_launches", {})
    step_chain_launches(prof["device_launches"], feeds)
    rows = {}
    for ph, phase_rec, feed in (("p2plane", p2_rec, "single_device"),
                                ("p2point", pp_rec, "p2point")):
        r = solve_dev.get(ph) or {}
        rows[ph] = {
            "solve_ms_per_iteration_phase_events": phase_rec.get(
                "ms_per_gn_iteration", phase_rec.get("ms_per_icp_iteration")),
            **{k: r.get(k) for k in (
                "replay_ms_per_iteration", "device_ms_per_iteration",
                "device_launches_per_iteration",
                "eager_body_launches_per_iteration")},
            "device_launches_per_steady_scan": feeds.get(feed)}
    rows["sharded"] = {k: SHARDED_SOLVE.get(k) for k in (
        "replay_ms", "replay_ms_per_iteration", "device_ms",
        "device_ms_per_iteration", "device_launches_per_iteration")}
    rows["sharded"]["device_launches_per_steady_scan"] = feeds.get("sharded")
    emit({"phase": "solve_device_per_iteration",
          "counted_by": "solve ms: the solve phase's CUDA events over the "
                        "steady scans; replay ms: CUDA events around one "
                        "replay of the phase's last solve graph; device ms "
                        "and launches per iteration: torch.profiler over "
                        "that replay (the graph captured anew after a first "
                        "profiler session; also one body run eagerly); per "
                        "steady scan: torch.profiler over one drained "
                        "scan",
          "rows": rows, "before_one_commit_kernel": EAGER_COMMIT_SOLVE})
    for ph, kernel in (("p2plane", "loop_commit"), ("p2point", "p2p_step"),
                       ("p2point", "loop_commit"),
                       ("p2plane_step", "philox_keep"),
                       ("p2plane_step_octree", "philox"),
                       ("p2plane_step_octree", "philox_keep")):
        r = solve_dev.get(ph)
        check(r is not None and kernel in r["kernels"],
              f"{ph}: {kernel} not in the solve graph's replay: {r}")
    for e in entries:
        in_replay = {ph: r["kernels"][e["name"]]["mean_device_ms"]
                     for ph, r in list(solve_dev.items())
                     + [("sharded", SHARDED_SOLVE),
                        ("sharded_p2point_step", SHARDED_STEP_SOLVE)]
                     if r and e["name"] in r.get("kernels", {})}
        if in_replay:
            e["device_ms_in_replay"] = in_replay

    # ---- the kernels line: launches are the main paths' (every phase that
    # drives a Mapper, the pose graph's refinement, the CLI, the
    # distributed solve and the sharded mapper)
    for e in entries:
        runs = {"identity": id_launch, "p2plane": p2_launch,
                "default": df_launch, "p2point": pp_launch,
                "p2plane_step": st_launch,
                "p2plane_step_octree": so_launch,
                "tracing": tr_launch, "octree_k": ok_launch,
                "filters": fl_launch, "posegraph": pg_launch,
                "cli": cli_launch, "distributed": ds_launch,
                "sharded": sh_launch}
        for name, counts in runs.items():
            e[f"launches_{name}"] = counts.get(e["name"], 0)
        e["launches"] = sum(e[f"launches_{name}"] for name in runs)
        check(e["launches"] > 0, f"{e['name']} was never launched")
    print(card, flush=True)
    emit({"kernels": entries})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
