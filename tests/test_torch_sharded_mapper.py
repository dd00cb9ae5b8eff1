"""The port's sharded mapper on a one-rank gloo group against the JAX
package's ``ShardedMapper`` on ``make_mesh(1)``, on the CPU, with the same
numpy inputs.  The two packages compute the same function by different
searches (the port's matcher is the sorted sweep with exact distances, its
normals per-query centred moments; the JAX package on the CPU ranks by
``|p|² + |q|² - 2p·q`` and sums raw moments), so poses agree to the
accumulated f32 noise of those differences: 1e-4 on worlds whose planes lie
inside their voxels (``test_torch_mapper_e2e.make_world``).

Both packages are driven step-locked (``drain()`` after every scan), and the
rematch period is pinned in every test."""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import norlab_icp_mapper_tpu as nj
from norlab_icp_mapper_tpu.parallel import (ShardedMapConfig as JCfg,
                                            ShardedMapper as JSM,
                                            make_mesh as jmake_mesh)
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch.draws import (SITE_OCTREE_PRIO,
                                               SITE_RANDOM_SAMPLING)
from norlab_icp_mapper_tpu_torch.icp.engine import ICPEngine
from norlab_icp_mapper_tpu_torch.mapper_modules.core import (
    mapper_module_registry)
from norlab_icp_mapper_tpu_torch.parallel import (ShardedMapConfig,
                                                  ShardedMapper)

import test_mapper_e2e as jw
import test_sharded_map as tsm
from test_sharded_mapper import OPTS, SHARDED_CONFIG
from test_torch_distributed import free_port, one_rank_group  # noqa: F401
from test_torch_mapper_e2e import make_world, pose_at


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and small CPU ops split over every core slow down by an order of
    magnitude when the cores are shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _pin_rematch(monkeypatch):
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "3")


def corridor_cfg(**kw):
    """``tests/test_sharded_map.py``'s step config."""
    base = dict(dim=3, cell_size=4.8, voxel_size=0.3,
                min_dist_new_point=0.0, normal_radius=1.5,
                normal_min_knn=4, match_max_dist=1.0, max_iter=8,
                minimizer="PointToPlaneErrorMinimizer",
                update_condition="delay", update_value=0.05,
                halo_capacity=2048, sampling_method=0,
                window_enabled=False)
    base.update(kw)
    return base


def pair(mesh, kw, **port_kw):
    return (JSM(jmake_mesh(1), JCfg(**kw)),
            ShardedMapper(mesh, ShardedMapConfig(**kw), device="cpu",
                          **port_kw))


def feed(mj, mt, scan, est, stamp_s, drain=True, **kw):
    if mj is not None:
        mj.process_input(nj.PointBatch.from_numpy(scan, **kw.get("jdesc", {})),
                         est, stamp_s=stamp_s)
        if drain:
            mj.drain()
    mt.process_input(nt.PointBatch.from_numpy(scan, **kw.get("tdesc", {}),
                                              device="cpu"),
                     est, stamp_s=stamp_s)
    if drain:
        mt.drain()


def local_scan(world, pose, radius=10.0, cap=1024):
    d = pose.shape[0] - 1
    keep = np.linalg.norm(world - pose[:d, d], axis=1) < radius
    return ((world[keep] - pose[:d, d]) @ pose[:d, :d]).astype(
        np.float32)[:cap]


def voxels(pos, v=0.3):
    return {tuple(x) for x in np.floor(pos / np.float32(v)).astype(np.int64)}


def normals_agree(gt, gj, tol=1e-4):
    """Share of the port's map points whose normal equals (up to sign) the
    normal of the JAX map's point at the same place (within 1e-3 m)."""
    from scipy.spatial import cKDTree
    d, row = cKDTree(gj["positions"]).query(gt["positions"])
    a, b = gt["normals"][d < 1e-3], gj["normals"][row[d < 1e-3]]
    err = np.minimum(np.abs(a - b).max(1), np.abs(a + b).max(1))
    return float((err <= tol).mean()), int((d < 1e-3).sum())


# ------------------------------------------------------------------ e2e

def test_e2e_corridor_parity(rng, one_rank_group):
    """Point-to-plane over a corridor with noisy priors: poses within 1e-4
    at every scan, occupied voxels equal, counts equal, normals up to sign
    within 1e-4 on 99 % of points."""
    world = make_world(rng, n=1800)
    mj, mt = pair(one_rank_group, corridor_cfg(max_iter=12))
    nrng = np.random.default_rng(1)
    for i, x in enumerate([2.0, 2.5, 3.0, 3.5, 4.0, 4.5]):
        true = pose_at(x)
        est = true.copy()
        if i > 0:
            est[:3, 3] += nrng.normal(size=3).astype(np.float32) * 0.05
        feed(mj, mt, local_scan(world, true), est, 0.1 * i)
        np.testing.assert_allclose(mt.get_pose(), np.asarray(mj.get_pose()),
                                   atol=1e-4)
    m_t, m_j = mt.drain(), mj.drain()
    assert m_t["count"] == int(m_j["count"])
    assert m_t["merges_total"] == int(m_j["merges_total"]) == 5
    assert m_t["insert_overflow"] == 0 and m_t["halo_overflow"] == 0
    gt, gj = mt.get_map(), mj.get_map()
    assert voxels(gt["positions"]) == voxels(gj["positions"])
    share, n = normals_agree(gt, gj)
    assert n >= 0.99 * gt["positions"].shape[0] and share >= 0.99, (share, n)
    assert [len(x) for x in (mt.trajectory, mj.trajectory)] == [6, 6]
    assert mt.trajectory.timestamps == mj.trajectory.timestamps


@pytest.mark.parametrize("period", ["1", "3"])
def test_sharded_e2e_corrects_and_grows(rng, one_rank_group, monkeypatch,
                                        period):
    """``tests/test_sharded_map.py``'s test on its own world (whole walls on
    voxel faces) and config.  At rematch period 1 the port meets the
    reference's bar: the final pose beats the noisy prior (error below 0.6
    of it), the map grows without overflow, voxels unique, normals set.  At
    the default period 3, where the reference itself misses that bar, the
    port's final error is the reference's within 1 mm (the walls on voxel
    faces flip map content with the last bit of a pose, so this world
    holds no tighter bound).  One rank holds what the reference's eight
    shards hold, so its halo buffer is eight of theirs."""
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", period)
    world = tsm.make_world(rng)
    noise = rng.normal(0, 0.15, size=(8, 3)).astype(np.float32)
    mj, mt = pair(one_rank_group, corridor_cfg(max_iter=12,
                                               halo_capacity=8 * 2048))
    if period == "1":
        mj = None
    for i, x in enumerate(np.arange(2.0, 18.0, 2.0)):
        pose = tsm.pose_at(x)
        est = pose.copy()
        if i > 0:
            est[:3, 3] += noise[i]
        feed(mj, mt, local_scan(world, pose, cap=2048), est, float(i) * 0.1)
    m = mt.drain()
    final_true = tsm.pose_at(16.0)
    err = np.linalg.norm(mt.get_pose()[:3, 3] - final_true[:3, 3])
    if mj is not None:
        err_j = np.linalg.norm(np.asarray(mj.get_pose())[:3, 3]
                               - final_true[:3, 3])
        assert abs(err - err_j) < 1e-3, (err, err_j)
        return
    assert m["count"] > 500
    assert m["insert_overflow"] == 0 and m["halo_overflow"] == 0
    assert err < 0.6 * np.linalg.norm(noise[-1]), (err, noise[-1])
    out = mt.get_map()
    scaled = out["positions"].astype(np.float64) / 0.3
    vox = np.floor(scaled).astype(np.int64)
    frac = scaled - vox
    interior = np.all((frac > 1e-5) & (frac < 1 - 1e-5), axis=1)
    assert interior.mean() > 0.5
    assert np.unique(vox[interior], axis=0).shape[0] == interior.sum()
    assert (np.linalg.norm(out["normals"], axis=1) > 0.5).mean() > 0.8


# ------------------------------------------------------- solve parities

def _map_and_reading(rng, xyz_err, normals=False):
    world = jw.make_world(rng, n=900)
    true_pose = jw.pose_at(5.0)
    scan_np = jw.scan_at(world, true_pose)
    est = true_pose.copy()
    est[:3, 3] += np.array(xyz_err, np.float32)
    desc = {}
    if normals:
        n3 = len(world) // 3
        nrm = np.zeros((len(world), 3), np.float32)
        nrm[:n3, 2] = 1.0
        nrm[n3:, 1] = 1.0
        desc = {"normals": nrm}
    return world.astype(np.float32), desc, scan_np, est, true_pose


def _solve_three_ways(one_rank_group, rng, icp_cfg, kw, xyz_err, normals):
    world, desc, scan_np, est, true_pose = _map_and_reading(
        rng, xyz_err, normals)
    eng = ICPEngine(copy.deepcopy(icp_cfg), dim=3)
    eng.set_map(nt.PointBatch.from_numpy(world, desc, device="cpu"))
    reading = nt.PointBatch.from_numpy(
        (scan_np @ est[:3, :3].T + est[:3, 3]).astype(np.float32),
        device="cpu")
    T1 = eng(reading).correction.numpy()
    eye = np.eye(4, dtype=np.float32)
    mj, mt = pair(one_rank_group, kw)
    mj.bootstrap(nj.PointBatch.from_numpy(world, desc), eye)
    mt.bootstrap(nt.PointBatch.from_numpy(world, desc, device="cpu"), eye)
    feed(mj, mt, scan_np, est, 1.0)
    Tt = mt.get_pose() @ np.linalg.inv(est)
    Tj = np.asarray(mj.get_pose()) @ np.linalg.inv(est)
    return Tt, Tj, T1, mt.get_pose(), est, true_pose


def test_p2point_minimizer_parity_sharded_vs_single(rng, one_rank_group):
    """The distributed weighted Kabsch (reduced cross moments, the rigid
    increment from ``ops/kabsch.py`` on the moments' device, no host read)
    against the JAX package's sharded solve (its SVD) and the port's
    single-device Kabsch minimizer, both within the JAX test's 5e-3."""
    icp_cfg = {
        "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 1.0}},
        "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.9}}],
        "errorMinimizer": "PointToPointErrorMinimizer",
        "transformationCheckers": [
            {"CounterTransformationChecker": {"maxIterationCount": 15}}]}
    kw = dict(dim=3, cell_size=2.0, voxel_size=0.0, min_dist_new_point=0.0,
              minimizer="PointToPointErrorMinimizer", match_max_dist=1.0,
              max_iter=15, trimmed_ratio=0.9, update_condition="delay",
              update_value=1e9, window_enabled=False)
    Tt, Tj, T1, corrected, est, true_pose = _solve_three_ways(
        one_rank_group, rng, icp_cfg, kw, [0.15, -0.1, 0.08], False)
    assert np.abs(Tt - Tj).max() < 5e-3
    assert np.abs(Tt - T1).max() < 5e-3
    err = np.linalg.norm(corrected[:3, 3] - true_pose[:3, 3])
    assert err < 0.5 * np.linalg.norm(est[:3, 3] - true_pose[:3, 3])


@pytest.mark.parametrize("minimizer,inspect", [
    ("PointToPointErrorMinimizer", False),
    ("PointToPlaneErrorMinimizer", True)])
def test_loop_stopping_on_done_equals_the_masked_loop(rng, one_rank_group,
                                                      minimizer, inspect):
    """The sharded solve as the card's graph runs it -- all ``max_iter``
    iterations, those after the stop masked -- against the loop that reads
    the replicated ``done`` and stops (the CPU's): T, overlap, iterations,
    the inspector's history and the overflow count bit for bit, with a
    keyed random step filter drawing at the same solve index, and the stop
    well before ``max_iter``."""
    from norlab_icp_mapper_tpu_torch.draws import DrawSource
    from norlab_icp_mapper_tpu_torch.filters.core import FilterChain
    from norlab_icp_mapper_tpu_torch.parallel.sharded_map import _ShardedLoop
    world, desc, scan_np, est, _ = _map_and_reading(rng, [0.12, -0.08, 0.05],
                                                    True)
    step_chain = FilterChain.from_yaml(
        [{"RandomSamplingDataPointsFilter": {"prob": 0.8}}])
    cfg = ShardedMapConfig(
        dim=3, cell_size=2.0, voxel_size=0.0, minimizer=minimizer,
        match_max_dist=1.0, max_iter=30, trimmed_ratio=0.9,
        diff_checker=(1e-3, 1e-3, 3), step_filter=step_chain._apply_impl,
        update_condition="delay", update_value=1e9, window_enabled=False,
        inspect=inspect)
    sm = ShardedMapper(one_rank_group, cfg, device="cpu")
    sm.bootstrap(nt.PointBatch.from_numpy(world, desc, device="cpu"),
                 np.eye(4, dtype=np.float32))
    scan_m = torch.from_numpy(
        (scan_np @ est[:3, :3].T + est[:3, 3]).astype(np.float32))
    mask = torch.ones(scan_m.shape[0], dtype=torch.bool)
    st = sm.state
    outs = []
    for stop in (True, False):
        loop = _ShardedLoop(sm.step, scan_m, mask, st["pos"], st["nrm"],
                            st["msk"], draws=DrawSource(7),
                            solve_index=torch.tensor(5))
        outs.append(loop.run(stop=stop))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    T, overlap, iters, ihist, _ = outs[0]
    assert 3 < int(iters) < 30
    assert 0.5 < float(overlap) <= 1.0
    if inspect:
        assert (ihist[:int(iters), 0] > 0).all()
        assert (ihist[int(iters):] == 0).all()


def test_outlier_filter_chain_parity_sharded_vs_single(rng, one_rank_group):
    """maxdist, median, trimmed and the normal-angle gate on the reduced
    distances: within the JAX test's 5e-3 of the JAX sharded solve and of
    the port's single-device engine."""
    icp_cfg = {
        "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 1.5}},
        "outlierFilters": [
            {"MaxDistOutlierFilter": {"maxDist": 0.8}},
            {"MedianDistOutlierFilter": {"factor": 3.0}},
            {"TrimmedDistOutlierFilter": {"ratio": 0.95}},
            {"SurfaceNormalOutlierFilter": {"maxAngle": 1.3}},
        ],
        "errorMinimizer": "PointToPlaneErrorMinimizer",
        "transformationCheckers": [
            {"CounterTransformationChecker": {"maxIterationCount": 12}}],
    }
    kw = dict(dim=3, cell_size=2.0, voxel_size=0.0, min_dist_new_point=0.0,
              minimizer="PointToPlaneErrorMinimizer", match_max_dist=1.5,
              max_iter=12,
              outlier_filters=(("maxdist", 0.8), ("median", 3.0),
                               ("trimmed", 0.95), ("normal", 1.3)),
              update_condition="delay", update_value=1e9,
              window_enabled=False)
    Tt, Tj, T1, corrected, est, true_pose = _solve_three_ways(
        one_rank_group, rng, icp_cfg, kw, [0.12, -0.08, 0.06], True)
    assert np.abs(Tt - Tj).max() < 5e-3
    assert np.abs(Tt - T1).max() < 5e-3
    err = np.linalg.norm(corrected[:3, 3] - true_pose[:3, 3])
    assert err < np.linalg.norm(est[:3, 3] - true_pose[:3, 3])


def test_dynamic_points_parity_sharded_vs_single(rng, one_rank_group):
    """The in-merge Bayesian update against the port's single-device
    DynamicPointsMapperModule and against the JAX sharded update:
    probabilities within 2e-5 on more than 99 % of the original points."""
    world = jw.make_world(rng, n=600).astype(np.float32)
    pose = jw.pose_at(5.0)
    scan_np = jw.scan_at(world, pose)
    dp = {"thresholdDynamic": 0.9, "alpha": 0.8, "beta": 0.99,
          "beamHalfAngle": 0.05, "epsilonA": 0.01, "epsilonD": 0.01,
          "sensorMaxRange": 20.0}
    n = len(world)
    desc = {"normals": np.tile(np.array([0, 0, 1], np.float32), (n, 1)),
            "probabilityDynamic": np.full((n, 1), 0.4, np.float32)}
    sdesc = {"probabilityDynamic": np.full((len(scan_np), 1), 0.4,
                                           np.float32)}
    module = mapper_module_registry.create("DynamicPointsMapperModule",
                                           dict(dp))
    scan_w = nt.PointBatch.from_numpy(
        (scan_np @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32), sdesc,
        device="cpu")
    single = module.update_map(scan_w, nt.PointBatch.from_numpy(
        world, desc, device="cpu"), torch.from_numpy(pose))
    single = single.descriptors["probabilityDynamic"].numpy()[:n, 0]

    kw = dict(dim=3, cell_size=2.0, voxel_size=0.0, min_dist_new_point=1e-3,
              normal_radius=1.5, minimizer="IdentityErrorMinimizer",
              update_condition="delay", update_value=0.01,
              dynamic_points=dp, halo_capacity=2048, window_enabled=False)
    mj, mt = pair(one_rank_group, kw)
    eye = np.eye(4, dtype=np.float32)
    mj.bootstrap(nj.PointBatch.from_numpy(world, desc), eye)
    mt.bootstrap(nt.PointBatch.from_numpy(world, desc, device="cpu"), eye)
    feed(mj, mt, scan_np, pose, 1.0, jdesc=dict(descriptors=sdesc),
         tdesc=dict(descriptors=sdesc))
    from scipy.spatial import cKDTree
    tree = cKDTree(world)
    for out in (mt.get_map(), mj.get_map()):
        d, row = tree.query(out["positions"])
        original = d < 1e-5
        got = out["probabilityDynamic"][original, 0]
        diff = np.abs(got - single[row[original]])
        assert (diff < 2e-5).mean() > 0.99, (diff.max(), (diff >= 2e-5).sum())
        assert diff.max() < 0.1
    # the insert gate at 1e-3 m: the port's exact distances keep out the
    # scan's copies of map points; the JAX package's |p|^2 + |q|^2 - 2p.q
    # on the CPU can leave one past the gate (its error is ~|p|^2 eps),
    # and nothing else differs
    pt, pj = mt.get_map(), mj.get_map()
    d, row = cKDTree(pj["positions"]).query(pt["positions"])
    assert (d == 0).all()
    extra = np.setdiff1d(np.arange(len(pj["positions"])), row)
    assert len(extra) <= 0.01 * len(pt["positions"])
    assert (cKDTree(pt["positions"]).query(pj["positions"][extra])[0]
            < 1e-3).all()
    diff = np.abs(pt["probabilityDynamic"][:, 0]
                  - pj["probabilityDynamic"][row, 0])
    assert (diff < 2e-5).mean() > 0.99
    assert np.abs(single - 0.4).max() > 0.01  # the update moved some


# -------------------------------------------------------- the facade

class JaxFacadeDraws:
    """The JAX facade's draws for the port's ``draw_source``: per scan one
    key split for the input chain and one for the reading filters (whose
    chain splits once more per filter), and the step filters' draws from
    ``fold_in(PRNGKey(scan_index), it)`` split once, at the matcher passes
    ``it = 0, R, 2R, ...`` (R the rematch period)."""

    def __init__(self, mapper_t, period=3):
        self.key = jax.random.PRNGKey(0)
        self.mt = mapper_t
        self.period = period
        self.scan = None
        self.passes = 0

    def __call__(self, site, n):
        assert site == SITE_RANDOM_SAMPLING
        idx = self.mt._sharded._scan_index
        if idx != self.scan or self.passes < 0:
            # the reading filter: the facade's second key of this scan
            self.scan, self.passes = idx, 0
            self.key, _ = jax.random.split(self.key)
            self.key, k = jax.random.split(self.key)
            _, sub = jax.random.split(k)
            return np.asarray(jax.random.uniform(sub, (n,)))
        it = self.period * self.passes
        self.passes += 1
        _, sub = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(idx), it))
        return np.asarray(jax.random.uniform(sub, (n,)))


def facade_pair(mesh, cfg, draws=True, **kw):
    mj = nj.Mapper(copy.deepcopy(cfg), mesh=jmake_mesh(1),
                   sharded_options=OPTS, **kw)
    holder = {}
    src = (lambda site, n: holder["d"](site, n)) if draws else None
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu", mesh=mesh,
                   sharded_options=OPTS, draw_source=src, **kw)
    holder["d"] = JaxFacadeDraws(mt)
    return mj, mt, holder["d"]


def facade_feed(mapper, pkg, scan, est, stamp_ns, draws=None):
    batch = (pkg.PointBatch.from_numpy(scan) if pkg is nj
             else pkg.PointBatch.from_numpy(scan, device="cpu"))
    if draws is not None:
        draws.passes = -1  # the next draw is this scan's reading filter
    mapper.process_input(mapper.apply_input_filters(batch), est, stamp_ns)
    mapper.drain()


def facade_drive(mj, mt, draws, world, xs, noise=0.0, seed=7):
    nrng = np.random.default_rng(seed)
    for i, x in enumerate(xs):
        true = pose_at(x)
        est = true.copy()
        if noise and i > 0:
            est[:3, 3] += nrng.normal(size=3).astype(np.float32) * noise
        scan = local_scan(world, true, radius=15.0)
        if mj is not None:
            facade_feed(mj, nj, scan, est, int(i * 1e8))
        facade_feed(mt, nt, scan, est, int(i * 1e8), draws)


def test_facade_yaml_parity_with_reading_and_step_filters(rng,
                                                         one_rank_group):
    """``tests/test_sharded_mapper.py``'s YAML (random reading filter,
    trimmed filter, differential checker, DynamicPoints, octree, normals,
    cut) plus a random step filter, both packages fed the JAX facade's
    draws: poses within 1e-4, the same map."""
    cfg = copy.deepcopy(SHARDED_CONFIG)
    cfg["icp"]["readingStepDataPointsFilters"] = [
        {"RandomSamplingDataPointsFilter": {"prob": 0.8}}]
    world = make_world(rng, n=1800)
    mj, mt, draws = facade_pair(one_rank_group, cfg)
    facade_drive(mj, mt, draws, world, [2.0, 2.5, 3.0, 3.5, 4.0], 0.03)
    for a, b in zip(mt.get_trajectory().poses, mj.get_trajectory().poses):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-4)
    assert mt.get_trajectory().timestamps == mj.get_trajectory().timestamps
    gt, gj = mt.get_map(), mj.get_map()
    assert set(gt) == set(gj) >= {"positions", "normals",
                                  "probabilityDynamic"}
    assert voxels(gt["positions"]) == voxels(gj["positions"])
    assert np.isfinite(mt.get_pose()).all()
    assert float(mt.overlap) == pytest.approx(float(mj.overlap), abs=1e-4)


def test_sharded_performance_inspector_and_bound_checker(rng,
                                                         one_rank_group):
    """The PerformanceInspector's per-iteration (overlap, rms) from the
    solve's history, within 1e-4 of the JAX package's; the bound checker
    raises on the host as lpm throws."""
    world = make_world(rng, n=1800)
    cfg = copy.deepcopy(SHARDED_CONFIG)
    cfg["icp"]["inspector"] = "PerformanceInspector"
    mj, mt, draws = facade_pair(one_rank_group, cfg)
    facade_drive(mj, mt, draws, world, [2.0, 2.4, 2.8], 0.05)
    ht, hj = mt.icp.inspector.history, mj.icp.inspector.history
    assert len(ht) == len(hj) >= 2
    for a, b in zip(ht, hj):
        assert a["iteration"] == b["iteration"]
        assert a["overlap"] == pytest.approx(b["overlap"], abs=1e-4)
        assert a["residual"] == pytest.approx(b["residual"], abs=1e-4)
    assert any(h["residual"] > 0.0 for h in ht)
    assert mt._sharded.waits["inspect"] == 2

    cfg2 = copy.deepcopy(SHARDED_CONFIG)
    cfg2["icp"]["transformationCheckers"].append(
        {"BoundTransformationChecker": {"maxRotationNorm": 1.0,
                                        "maxTranslationNorm": 0.05}})
    m2 = nt.Mapper(cfg2, device="cpu", mesh=one_rank_group,
                   sharded_options=OPTS)
    facade_drive(None, m2, None, world, [2.0, 2.3])
    bad = pose_at(2.6)
    bad[:3, 3] += np.array([2.0, 0.0, 0.0], np.float32)
    scan = local_scan(world, pose_at(2.6), radius=15.0)
    with pytest.raises(RuntimeError, match="BoundTransformationChecker"):
        m2.process_input(m2.apply_input_filters(
            nt.PointBatch.from_numpy(scan, device="cpu")), bad, int(3e8))


def test_sharded_online_split_and_local_map(rng, one_rank_group):
    """``is_online=True`` gives the offline trajectory; the local map is a
    consume-once export that a merge re-arms."""
    world = make_world(rng, n=1800)
    xs = [2.0, 2.5, 3.0, 3.5]
    m_on = nt.Mapper(copy.deepcopy(SHARDED_CONFIG), is_online=True,
                     device="cpu", mesh=one_rank_group, sharded_options=OPTS)
    m_off = nt.Mapper(copy.deepcopy(SHARDED_CONFIG), device="cpu",
                      mesh=one_rank_group, sharded_options=OPTS)
    assert m_on._sharded.is_online
    facade_drive(None, m_on, None, world, xs, 0.05)
    facade_drive(None, m_off, None, world, xs, 0.05)
    for a, b in zip(m_on.get_trajectory().poses,
                    m_off.get_trajectory().poses):
        np.testing.assert_allclose(a, b, atol=1e-4)
    local = m_on.get_new_local_map()
    assert local is not None and local["positions"].shape[0] > 100
    assert m_on.get_new_local_map() is None, "not consumed"
    facade_feed(m_on, nt, local_scan(world, pose_at(4.0), radius=15.0),
                pose_at(4.0), int(1e9))
    assert m_on.get_new_local_map() is not None, \
        "merge did not re-arm the local map"
    m_on.shutdown()


def test_sharded_keyframes_match_jax(rng, one_rank_group):
    """``enable_keyframes`` through the facade: the sharded mapper captures a
    keyframe at merges spaced ``min_distance`` apart, into the store the
    facade shares; the same keyframes (sensor-frame scans, poses within
    1e-4) as the JAX package's."""
    world = make_world(rng, n=1800)
    mj, mt, draws = facade_pair(one_rank_group, SHARDED_CONFIG)
    for m in (mj, mt):
        m.enable_keyframes(min_distance=0.5)
    facade_drive(mj, mt, draws, world, [2.0, 2.3, 2.6, 3.2, 3.8], 0.03)
    kt, kj = mt.get_keyframes(), mj.get_keyframes()
    assert kt is not None and len(kt[2]) == len(kj[2]) >= 3
    np.testing.assert_allclose(kt[2], np.asarray(kj[2]), atol=1e-4)
    np.testing.assert_array_equal(kt[1].numpy(), np.asarray(kj[1]))
    np.testing.assert_array_equal(kt[0].numpy(), np.asarray(kj[0]))
    assert mt.keyframe_thinning_events == 0
    assert mt._keyframes is mt._sharded._keyframes


# ------------------------------------------------------ window and growth

def test_window_eviction_bounded_and_lossless(rng, one_rank_group):
    """Out and back along a corridor much longer than the window, the JAX
    package beside the port, both drained after every scan: the same cells
    spilled, the same device-resident counts, a bounded block, and a
    global map whose occupied voxels equal the no-window run's and the JAX
    package's (one rank's halo buffer is eight of the JAX test's shards').
    """
    world = tsm.make_long_corridor(rng, length=84.0)
    xs = list(np.arange(2.0, 82.0, 4.0))
    xs_full = xs + xs[::-1]

    def run(window):
        kw = corridor_cfg(minimizer="IdentityErrorMinimizer",
                          window_enabled=window, sensor_max_range=8.0,
                          evict_capacity=8192, halo_capacity=8 * 2048)
        mj, mt = pair(one_rank_group, kw)
        if not window:
            mj = None
        peak = 0
        for i, x in enumerate(xs_full):
            pose = tsm.pose_at(x)
            feed(mj, mt, local_scan(world, pose, radius=8.0, cap=2048), pose,
                 0.1 * i)
            peak = max(peak, len(mt.cell_manager.get_all_cell_ids()))
            if mj is not None and i > 0:
                ids_t = sorted(mt.cell_manager.get_all_cell_ids())
                assert ids_t == sorted(mj.cell_manager.get_all_cell_ids())
                assert mt.drain()["count"] == int(mj.drain()["count"])
        return mj, mt, peak

    wj, win, peak = run(True)
    _, ref, _ = run(False)
    assert peak > 0, "the window never evicted"
    assert win.overflow_totals["evict"] == 0
    m_win, m_ref = win.drain(), ref.drain()
    assert m_win["insert_overflow"] == 0 and m_win["halo_overflow"] == 0
    assert win.capacity() <= ref.capacity()
    assert m_win["count"] < m_ref["count"]
    gw, gr, gj = win.get_map(), ref.get_map(), wj.get_map()
    assert voxels(gw["positions"]) == voxels(gr["positions"]) \
        == voxels(gj["positions"])
    assert win.window.w == wj.window.w
    np.testing.assert_array_equal(win.table_np, wj.table_np)


@pytest.mark.parametrize("step_m", [10.0, 40.0], ids=["realistic",
                                                      "teleport"])
def test_sharded_leave_return_leave_no_duplication(rng, one_rank_group,
                                                   step_m):
    """Revisit cycles do not duplicate the map (the teleport variant moves
    the prior more than a window cell per scan: saved cells must come back
    before the re-observing scan merges)."""
    from test_rolling_window import corridor_world
    world = corridor_world(rng, length=160.0, n=2200)
    cfg = {
        "icp": {
            "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 1.0}},
            "errorMinimizer": "IdentityErrorMinimizer",
            "transformationCheckers": [
                {"CounterTransformationChecker": {"maxIterationCount": 1}}],
        },
        "input": [], "post": [],
        "mapper": {
            "updateCondition": {"type": "delay", "value": 0.05},
            "mapperModule": [{"PointDistanceMapperModule":
                              {"minDistNewPoint": 0.1}}],
            "sensorMaxRange": 15,
        },
    }
    mapper = nt.Mapper(cfg, device="cpu", mesh=one_rank_group,
                       sharded_options=OPTS)
    out_xs = np.arange(2.0, 130.0, step_m)
    step, counts = 0, []
    for cycle in range(3):
        for xs in (out_xs, out_xs[::-1]):
            for x in xs:
                pose = pose_at(x)
                scan = local_scan(world, pose, radius=15.0, cap=4096)
                mapper.process_input(mapper.apply_input_filters(
                    nt.PointBatch.from_numpy(scan, device="cpu")), pose,
                    int(step * 1e8))
                step += 1
        mapper.drain()
        counts.append(mapper.get_map()["positions"].shape[0])
    assert counts[2] <= counts[0] * 1.10, counts


def test_sharded_2d(rng, one_rank_group):
    """SE(2) end to end with the window on: poses within 1e-4 of the JAX
    package's, the prior's noise corrected (the reference's bar)."""
    n = 900
    t = rng.uniform(0, 30, n).astype(np.float32)
    side = rng.integers(0, 4, n)
    x = np.where(side <= 1, t, np.where(side == 2, 0.07, 30.07))
    y = np.where(side == 0, 0.07, np.where(side == 1, 12.07, t * 0.4))
    world = np.stack([x, y], 1).astype(np.float32)
    kw = corridor_cfg(dim=2, max_iter=10, normal_radius=2.0, voxel_size=0.2,
                      window_enabled=True, sensor_max_range=10.0)
    mj, mt = pair(one_rank_group, kw)
    noise = rng.normal(0, 0.1, size=(10, 2)).astype(np.float32)
    for i, px in enumerate(np.arange(2.0, 26.0, 3.0)):
        pose = pose_at(px, dim=2)
        pose[1, 2] = 6.0
        est = pose.copy()
        if i > 0:
            est[:2, 2] += noise[i]
        feed(mj, mt, local_scan(world, pose), est, 0.1 * i)
        np.testing.assert_allclose(mt.get_pose(), np.asarray(mj.get_pose()),
                                   atol=1e-4)
    m = mt.drain()
    assert m["count"] > 200 and m["count"] == int(mj.drain()["count"])
    err = np.linalg.norm(mt.get_pose()[:2, 2] - np.array([23.0, 6.0]))
    assert err < 0.7 * np.linalg.norm(noise[8]), err
    assert mt.get_map()["positions"].shape[1] == 2


def test_growth_preserves_the_blocks(rng, one_rank_group):
    """Capacity growth from a 1,024-slot start: the block grows, stays on
    the mapper's device with every leaf the same length, and loses nothing
    against an unconstrained run."""
    world = tsm.make_world(rng)
    kw = corridor_cfg(minimizer="IdentityErrorMinimizer")
    small = ShardedMapper(one_rank_group, ShardedMapConfig(**kw),
                          device="cpu")
    big = ShardedMapper(one_rank_group, ShardedMapConfig(**kw), device="cpu")
    first = nt.PointBatch.from_numpy(local_scan(world, tsm.pose_at(2.0),
                                                cap=2048), device="cpu")
    small.bootstrap(first, tsm.pose_at(2.0), capacity=1024)
    big.bootstrap(first, tsm.pose_at(2.0), capacity=65536)
    cap0 = small.capacity()
    for i, x in enumerate(np.arange(4.0, 20.0, 2.0)):
        for m in (small, big):
            m.process_input(nt.PointBatch.from_numpy(local_scan(
                world, tsm.pose_at(x), cap=2048), device="cpu"),
                tsm.pose_at(x), stamp_s=0.1 * (i + 1))
    assert small.capacity() > cap0, "never grew"
    assert {v.shape[0] for v in small.state.values()} == {small.capacity()}
    assert all(v.device.type == "cpu" for v in small.state.values())
    assert small.drain()["count"] == big.drain()["count"]
    assert voxels(small.get_map()["positions"]) == \
        voxels(big.get_map()["positions"])


def test_random_voxel_sampling_with_the_reference_draws(rng, one_rank_group):
    """``samplingMethod: 1`` with the JAX package's per-rank draws
    (``randint(fold_in(PRNGKey(scan), rank), 0, 2**15)``) fed to the
    port: the same representatives, so the same map point for point."""
    world = make_world(rng, n=1800)
    kw = corridor_cfg(minimizer="IdentityErrorMinimizer", sampling_method=1,
                      voxel_size=0.15)
    holder = {}

    def source(site, n):
        assert site == SITE_OCTREE_PRIO
        key = jax.random.fold_in(jax.random.PRNGKey(
            holder["mt"]._scan_index), 0)
        return np.asarray(jax.random.randint(key, (n,), 0, 1 << 15,
                                             dtype=jnp.int32))

    mj, mt = pair(one_rank_group, kw, draw_source=source)
    holder["mt"] = mt
    for i, x in enumerate([2.0, 2.6, 3.2, 3.8]):
        feed(mj, mt, local_scan(world, pose_at(x)), pose_at(x), 0.1 * i)
    gt, gj = mt.get_map(), mj.get_map()
    np.testing.assert_array_equal(np.sort(gt["positions"], axis=0),
                                  np.sort(gj["positions"], axis=0))


# -------------------------------------------------------------- checkpoints

def test_checkpoints_cross_between_the_packages(rng, one_rank_group,
                                                tmp_path):
    """A checkpoint the JAX package writes loads into the port, whose next
    scans follow the JAX package's uninterrupted continuation within 1e-4;
    a checkpoint the port writes loads into the JAX package with the same
    arrays."""
    world = make_world(rng, n=1800)
    kw = corridor_cfg(window_enabled=True, sensor_max_range=8.0)
    noise = np.random.default_rng(3).normal(0, 0.05, size=(8, 3)).astype(
        np.float32)
    xs = [2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0, 5.5]

    def step(m, i, pkg):
        pose = pose_at(xs[i])
        est = pose.copy()
        est[:3, 3] += noise[i]
        batch = (pkg.PointBatch.from_numpy(local_scan(world, pose))
                 if pkg is nj else pkg.PointBatch.from_numpy(
                     local_scan(world, pose), device="cpu"))
        m.process_input(batch, est, timestamp_ns=int(i * 1e8))
        m.drain()
        return np.asarray(m.get_pose())

    base = JSM(jmake_mesh(1), JCfg(**kw))
    for i in range(5):
        step(base, i, nj)
    path = str(tmp_path / "jax.npz")
    base.save_checkpoint(path)
    resumed = ShardedMapper.load_checkpoint(
        path, one_rank_group, ShardedMapConfig(**kw), device="cpu")
    assert resumed.trajectory.timestamps == base.trajectory.timestamps[:5]
    for i in range(5, 8):
        np.testing.assert_allclose(step(resumed, i, nt), step(base, i, nj),
                                   atol=1e-4)

    path_t = str(tmp_path / "port.npz")
    resumed.save_checkpoint(path_t)
    back = JSM.load_checkpoint(path_t, jmake_mesh(1), JCfg(**kw))
    saved = np.load(path_t)
    for k in ("pos", "nrm", "msk", "prob"):
        np.testing.assert_array_equal(np.asarray(back.state[k]),
                                      saved[f"state_{k}"])
    np.testing.assert_array_equal(back.table_np, saved["bucket_table"])
    assert back.window.w == resumed.window.w
    assert back._scan_index == resumed._scan_index == 8
    assert sorted(back.cell_manager.get_all_cell_ids()) == \
        sorted(resumed.cell_manager.get_all_cell_ids())
