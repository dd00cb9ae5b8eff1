"""The port's ``ShardedMapper`` on 2 and 4 gloo ranks in spawned processes
(``tests/torch_dist_worker.py::run_sharded_rank``, which imports no JAX)
against one rank in this process and against the JAX package's
``ShardedMapper`` on ``make_mesh(2)`` / ``make_mesh(4)``: poses within 1e-4,
occupied voxels equal whatever the number of ranks, exact normals across
rank borders (the halo), the rebalance, and a rolling window whose
replicated host state (table, window, cell ids) every rank holds bit for
bit.  Each spawn has a time limit, so a rank that hangs in a collective
fails the test instead of stalling the suite.  The spawns are shared by
the tests of this file (one for each number of ranks)."""
import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

import norlab_icp_mapper_tpu as nj
from norlab_icp_mapper_tpu.parallel import (ShardedMapConfig as JCfg,
                                            ShardedMapper as JSM,
                                            make_mesh as jmake_mesh)
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch.parallel import (ShardedMapConfig,
                                                  ShardedMapper, make_mesh,
                                                  multihost)

import test_sharded_map as tsm
import torch_dist_worker
from test_torch_distributed import free_port
from test_torch_mapper_e2e import make_world, pose_at
from test_torch_sharded_mapper import corridor_cfg, local_scan, voxels

SPAWN_TIMEOUT_S = 240
REMATCH = 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and small CPU ops split over every core slow down by an order of
    magnitude when the cores are shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cases(world_ranks):
    """The drives every number of ranks runs (numpy only)."""
    rng = np.random.default_rng(42)
    world = make_world(rng, n=1800)
    nrng = np.random.default_rng(1)
    xs = [2.0, 2.5, 3.0, 3.5, 4.0, 4.5]
    scans, ests, trues = [], [], []
    for i, x in enumerate(xs):
        true = pose_at(x)
        est = true.copy()
        if i > 0:
            est[:3, 3] += nrng.normal(size=3).astype(np.float32) * 0.05
        scans.append(local_scan(world, true))
        ests.append(est)
        trues.append(true)
    small = dict(cell_size=2.0, halo_capacity=4096, max_iter=12)
    out = [
        dict(name="p2plane", cfg=corridor_cfg(**small), scans=scans,
             ests=ests),
        dict(name="identity", cfg=corridor_cfg(
            minimizer="IdentityErrorMinimizer", **small), scans=scans,
            ests=trues),
    ]
    # point-to-point with the differential checker and a random step
    # filter: the loop stops on the replicated ``done`` well before
    # max_iter, and the step mask is drawn keyed alike on every rank
    out.append(dict(
        name="stops", cfg=corridor_cfg(
            minimizer="PointToPointErrorMinimizer", cell_size=2.0,
            halo_capacity=4096, max_iter=30,
            diff_checker=(1e-3, 1e-3, 3)),
        step_yaml=[{"RandomSamplingDataPointsFilter": {"prob": 0.8}}],
        scans=scans, ests=ests))
    if world_ranks == 2:
        w = tsm.make_world(np.random.default_rng(42))
        out.append(dict(
            name="rebalance",
            cfg=corridor_cfg(minimizer="IdentityErrorMinimizer",
                             cell_size=1.2),
            attrs={"REBALANCE_MIN_POINTS": 500, "REBALANCE_COOLDOWN": 2},
            zero_table=True,
            scans=[local_scan(w, tsm.pose_at(x), cap=2048)
                   for x in np.arange(2.0, 20.0, 2.0)],
            ests=[tsm.pose_at(x) for x in np.arange(2.0, 20.0, 2.0)]))
        long = tsm.make_long_corridor(np.random.default_rng(42),
                                      length=100.0)
        xw = list(np.arange(2.0, 92.0, 6.0))
        xw = xw + xw[::-1]
        out.append(dict(
            name="window",
            cfg=corridor_cfg(minimizer="IdentityErrorMinimizer",
                             window_enabled=True, sensor_max_range=8.0,
                             evict_capacity=8192, cell_size=2.0),
            scans=[local_scan(long, tsm.pose_at(x), radius=8.0, cap=2048)
                   for x in xw],
            ests=[tsm.pose_at(x) for x in xw]))
    return out


def spawn(world, out_dir):
    """``world`` ranks of ``run_sharded_rank``; fails (and kills them) past
    ``SPAWN_TIMEOUT_S``."""
    job = {"cases": cases(world), "rematch": REMATCH}
    ctx = tmp.spawn(torch_dist_worker.run_sharded_rank,
                    args=(world, free_port(), str(out_dir), job),
                    nprocs=world, join=False)
    deadline = time.time() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.time() > deadline:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
            pytest.fail(f"{world} ranks did not finish within "
                        f"{SPAWN_TIMEOUT_S} s (a collective hung?)")
    return {c["name"]: [dict(np.load(os.path.join(
        out_dir, f"{c['name']}_rank{r}.npz"))) for r in range(world)]
        for c in job["cases"]}


def in_process():
    """The cases on one rank in this process."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        os.environ.pop(k, None)
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    out = {}
    try:
        mesh = make_mesh()
        for c in cases(2):
            sm = ShardedMapper(mesh, torch_dist_worker.sharded_config(c),
                               device="cpu")
            for i, (scan, est) in enumerate(zip(c["scans"], c["ests"])):
                sm.process_input(nt.PointBatch.from_numpy(scan, device="cpu"),
                                 est, stamp_s=0.1 * i)
                sm.drain()
            g = sm.get_map()
            out[c["name"]] = dict(poses=np.stack(sm.trajectory.poses),
                                  positions=g["positions"],
                                  normals=g["normals"])
    finally:
        dist.destroy_process_group()
    return out


def jax_run(c, n):
    mj = JSM(jmake_mesh(n), JCfg(**c["cfg"]))
    for i, (scan, est) in enumerate(zip(c["scans"], c["ests"])):
        mj.process_input(nj.PointBatch.from_numpy(scan), est,
                         stamp_s=0.1 * i)
        mj.drain()
    return mj


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    old = os.environ.get("NIM_TPU_REMATCH_EVERY")
    os.environ["NIM_TPU_REMATCH_EVERY"] = str(REMATCH)
    try:
        out = {1: in_process()}
        for world in (2, 4):
            out[world] = spawn(world, tmp_path_factory.mktemp(f"s{world}"))
        yield out
    finally:
        if old is None:
            os.environ.pop("NIM_TPU_REMATCH_EVERY", None)
        else:
            os.environ["NIM_TPU_REMATCH_EVERY"] = old


def by_case(name, world):
    return next(c for c in cases(world) if c["name"] == name)


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_agree_bit_for_bit(runs, world):
    """Every rank ends each case with the same poses, map, table, window
    and cell ids (``tests/test_multihost.py``: ranks agree bitwise), and
    none imported JAX; the searches over a rank's block take 1,024 / S
    queries per tile."""
    for name, ranks in runs[world].items():
        r0 = ranks[0]
        for r in ranks[1:]:
            for k in ("poses", "positions", "normals", "prob", "table",
                      "window", "cells", "count"):
                np.testing.assert_array_equal(r[k], r0[k], err_msg=name + k)
        assert not any(bool(r["jax_imported"]) for r in ranks)
        # the block searches keep one rank's tile extent: 1,024 / S queries
        assert int(r0["q_tile"]) == {2: 512, 4: 256}[world]


@pytest.mark.parametrize("world", [2, 4])
def test_ranks_stop_on_the_replicated_done_and_agree(runs, world):
    """The solve loop reads the all-reduced ``done`` on the CPU and stops:
    every rank stops at the same iteration of every scan, well before
    ``max_iter``, and ends bit for bit with the others; the keyed step
    draws are the same on every rank (same seed, same solve index)."""
    ranks = runs[world]["stops"]
    its = ranks[0]["iters"][1:]  # the first scan only bootstraps the map
    assert (its > 1).all() and (its < 30).all() and its.max() > 3
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["iters"], ranks[0]["iters"])
        np.testing.assert_array_equal(r["poses"], ranks[0]["poses"])
    assert np.isfinite(ranks[0]["poses"]).all()


@pytest.mark.parametrize("world", [2, 4])
def test_poses_match_jax_and_one_rank(runs, world):
    """Point-to-plane with noisy priors: poses within 1e-4 of the JAX
    package's on ``make_mesh(world)``, and the same occupied voxels.  (Not
    against one rank: the first-point voxel representative follows the
    block's slot order, which the layout sets, so the JAX package's own
    poses on 1 and 4 shards differ by 2e-3 on this drive.)"""
    got = runs[world]["p2plane"][0]
    mj = jax_run(by_case("p2plane", world), world)
    want = np.stack([np.asarray(p) for p in mj.trajectory.poses])
    np.testing.assert_allclose(got["poses"], want, atol=1e-4)
    assert int(got["insert_overflow"]) == 0
    assert int(got["halo_overflow"]) == 0
    assert voxels(got["positions"]) == voxels(mj.get_map()["positions"])


def test_layout_invariance(runs):
    """Identity: the same occupied voxels on 1, 2 and 4 ranks, and on the
    JAX package's two shards (``test_shard_layout_invariance``)."""
    sets = [voxels(runs[1]["identity"]["positions"])] + [
        voxels(runs[w]["identity"][0]["positions"]) for w in (2, 4)]
    mj = jax_run(by_case("identity", 2), 2)
    sets.append(voxels(mj.get_map()["positions"]))
    assert all(s == sets[0] for s in sets), [len(s) for s in sets]


@pytest.mark.parametrize("world", [2, 4])
def test_halo_normals_are_exact(runs, world):
    """The normals of points within ``normal_radius`` of a rank's cell edge
    (neighbours across ranks, reached through the halo) equal one rank's,
    up to sign, within 1e-4, wherever the two maps give the point the same
    neighbourhood (a representative the layout's slot order chose
    differently changes its neighbours' normals on either side)."""
    from scipy.spatial import cKDTree
    one = runs[1]["identity"]
    got = runs[world]["identity"][0]
    cfg = by_case("identity", world)["cfg"]
    cs, r = ShardedMapConfig(**cfg).cell_size, cfg["normal_radius"]
    p1, pg = one["positions"], got["positions"]
    d, row = cKDTree(p1).query(pg)
    same = d == 0
    assert same.mean() >= 0.99
    t1, tg = cKDTree(p1), cKDTree(pg)
    hood = lambda t, p, q: {tuple(x) for x in p[t.query_ball_point(q, r)]}
    keep = np.array([s and hood(tg, pg, q) == hood(t1, p1, q)
                     for s, q in zip(same, pg)])
    fx = pg[:, :2] - np.floor(pg[:, :2] / cs) * cs
    near = np.any((fx < r) | (fx > cs - r), axis=1) & keep
    a, b = got["normals"][near], one["normals"][row[near]]
    err = np.minimum(np.abs(a - b).max(1), np.abs(a + b).max(1))
    assert near.sum() >= 0.8 * len(pg)
    assert (err <= 1e-4).all(), (err.max(), (err > 1e-4).sum())


def test_rebalance_restores_load_balance(runs):
    """A table with every bucket on rank 0: the harvested balance drops, the
    table is rebuilt from the measured histogram and the points move
    without loss (``tests/test_sharded_map.py``'s test on two ranks)."""
    got = runs[2]["rebalance"][0]
    assert int(got["count"]) > 500
    assert int(got["last_rebalance"]) > 0, "rebalance never triggered"
    assert float(got["balance"]) >= 0.93, float(got["balance"])
    assert int(got["rebalance_overflow"]) == 0
    assert np.bincount(got["table"], minlength=2).min() > 0
    one = runs[1]["rebalance"]["positions"]
    assert voxels(got["positions"]) == voxels(one)
    assert len(got["positions"]) == len(one)


def test_window_state_replicated_and_equal_to_jax(runs):
    """Out and back along a corridor longer than the window on two ranks:
    every rank holds the same cell ids, table and window (checked above),
    and they equal the JAX package's on ``make_mesh(2)``; the global map
    equals it voxel for voxel."""
    got = runs[2]["window"][0]
    mj = jax_run(by_case("window", 2), 2)
    assert len(got["cells"]) > 0, "the window never evicted"
    assert sorted(got["cells"].tolist()) == sorted(
        mj.cell_manager.get_all_cell_ids())
    assert got["window"].tolist() == mj.window.w
    np.testing.assert_array_equal(got["table"], mj.table_np)
    assert voxels(got["positions"]) == voxels(mj.get_map()["positions"])
    assert voxels(got["positions"]) == voxels(
        runs[1]["window"]["positions"])
