"""Port parity, the slice as a whole: the same synthetic drive through the
JAX package's ``Mapper`` and the port's, for both bundled configs (CPU).

Sizes are chosen so that the two packages compute the same thing on the CPU:

* scans hold at most 1024 points and maps at most 2048, so the port's sweep
  windows (W = 1024 angular, 2048 normals, 8192 matcher) hold every
  candidate, like the reference's CPU engines (grid hash, brute-force PCA);
* both mappers get ``scan_valid_hint=4096``.  With less than 1024 free
  slots after a merge the reference replays the scan (the backstop of its
  adaptive headroom, which the port does not have); a roomy hint keeps it
  from firing at these sizes.

The rematch period is pinned, as the reference's own tests need it.
"""
import copy

import numpy as np
import pytest
import yaml
import jax
import jax.numpy as jnp
import torch

import norlab_icp_mapper_tpu as nj
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch import convert
from norlab_icp_mapper_tpu_torch.draws import (SITE_OCTREE_PRIO,
                                               SITE_RANDOM_SAMPLING)

HINT = 4096


@pytest.fixture(autouse=True)
def _pin_rematch(monkeypatch):
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "3")


def make_world(rng, n=900):
    """Corridor (floor + side walls) closed by end walls and crossed by a
    partition, so that all six degrees of freedom are constrained.  Every
    plane lies well inside the 0.15 m voxels of the bundled configs (at
    least 4 cm from a voxel face): points ON a face change voxel with the
    last bit of a pose, which is not what these tests are about."""
    k = n // 6
    u = lambda lo, hi, m: rng.uniform(lo, hi, size=m).astype(np.float32)
    full = lambda v, m: np.full(m, v, np.float32)
    parts = [
        np.column_stack([u(0, 20, 2 * k), u(-3, 3, 2 * k),
                         full(0.07, 2 * k)]),
        np.column_stack([u(0, 20, k), full(-3.07, k), u(0.07, 2, k)]),
        np.column_stack([u(0, 20, k), full(3.07, k), u(0.07, 2, k)]),
        np.column_stack([full(0.07, k // 2), u(-3, 3, k // 2),
                         u(0.07, 2, k // 2)]),
        np.column_stack([full(12.07, k // 2), u(-3, 3, k // 2),
                         u(0.07, 2, k // 2)]),
        np.column_stack([full(8.17, k), u(-1, 1, k), u(0.07, 2, k)]),
    ]
    return np.concatenate(parts)


def scan_at(world, pose, max_range=15.0):
    d = pose.shape[0] - 1
    R, t = pose[:d, :d], pose[:d, d]
    local = (world - t) @ R
    keep = np.linalg.norm(local, axis=1) < max_range
    return local[keep].astype(np.float32)


def pose_at(x, yaw=0.0, dim=3):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(dim + 1, dtype=np.float32)
    T[:2, :2] = [[c, -s], [s, c]]
    T[0, dim] = x
    return T


def bundled(name, exact):
    """The bundled YAML as a dict.  ``exact`` makes the run independent of
    the random draws, which cannot be taken out of the reference's jitted
    step: first-point voxel sampling, and a reading filter that keeps every
    point (every uniform is < 1)."""
    with open(f"examples/{name}") as fh:
        cfg = yaml.safe_load(fh)
    if exact:
        for m in cfg["mapper"]["mapperModule"]:
            if "OctreeMapperModule" in m:
                m["OctreeMapperModule"]["samplingMethod"] = 0
        for f in cfg["icp"].get("readingDataPointsFilters", []):
            if "RandomSamplingDataPointsFilter" in f:
                f["RandomSamplingDataPointsFilter"]["prob"] = 1.0
    return cfg


def octree_draws(site, n):
    """What the reference draws in its merge: it passes no key, so the
    priorities come from PRNGKey(0) at the union's length."""
    assert site == SITE_OCTREE_PRIO
    return torch.from_numpy(np.array(jax.random.randint(
        jax.random.PRNGKey(0), (n,), 0, 1 << 15, dtype=jnp.int32)))


class ReferenceDraws:
    """The draws of the reference ``Mapper(seed=0)``, for the port's
    ``draw_source``.  The reference splits its key twice per scan (once in
    ``apply_input_filters``, once in ``process_input``); the per-scan step
    splits the second key in four and hands the first part to the reading
    filters, whose chain splits once more per filter.  ``next_scan`` must be
    called before each scan is fed to the port."""

    def __init__(self):
        self.key = jax.random.PRNGKey(0)
        self.step_key = None

    def next_scan(self):
        self.key, _ = jax.random.split(self.key)
        self.key, self.step_key = jax.random.split(self.key)

    def __call__(self, site, n):
        if site == SITE_OCTREE_PRIO:
            return octree_draws(site, n)
        assert site == SITE_RANDOM_SAMPLING
        k_read = jax.random.split(self.step_key, 4)[0]
        _, sub = jax.random.split(k_read)
        return torch.from_numpy(np.array(jax.random.uniform(sub, (n,))))


def feed(mapper, batch_cls, scan, prior, stamp, **kw):
    mapper.process_input(
        mapper.apply_input_filters(batch_cls.from_numpy(scan, **kw)), prior,
        stamp, scan_valid_hint=HINT)


def drive_both(cfg, world, xs, noise, is_3d=True, draw_source=None):
    mj = nj.Mapper(copy.deepcopy(cfg), is_3d=is_3d)
    mt = nt.Mapper(copy.deepcopy(cfg), is_3d=is_3d, device="cpu",
                   draw_source=draw_source)
    dim = 3 if is_3d else 2
    nrng = np.random.default_rng(1)
    for i, x in enumerate(xs):
        true = pose_at(x, dim=dim)
        prior = true.copy()
        if i > 0 and noise:
            prior[:dim, dim] += nrng.normal(size=dim).astype(np.float32) * noise
        scan = scan_at(world, true)
        feed(mj, nj.PointBatch, scan, prior, i * int(1e8))
        if hasattr(draw_source, "next_scan"):
            draw_source.next_scan()
        feed(mt, nt.PointBatch, scan, prior, i * int(1e8), device="cpu")
    mj.drain()
    return mj, mt


def nn_fraction(a, b, tol):
    """Share of points of ``a`` with a point of ``b`` within ``tol``."""
    d = np.sqrt(((a[:, None, :] - b[None]) ** 2).sum(-1)).min(1)
    return float((d < tol).mean())


def voxel_agreement(a, b, vox=0.15):
    va = {tuple(v) for v in np.floor(a / vox).astype(np.int64)}
    vb = {tuple(v) for v in np.floor(b / vox).astype(np.int64)}
    return len(va & vb) / max(len(va | vb), 1)


def assert_maps_close(ga, gb, count_tol, nn_tol=1e-4, nn_share=0.99):
    na, nb = ga["positions"].shape[0], gb["positions"].shape[0]
    assert abs(na - nb) <= count_tol * max(na, nb), (na, nb)
    assert sorted(ga) == sorted(gb)
    assert nn_fraction(ga["positions"], gb["positions"], nn_tol) >= nn_share
    assert nn_fraction(gb["positions"], ga["positions"], nn_tol) >= nn_share


# --------------------------------------------------------------- identity

def test_identity_config_exact(rng):
    """Trusted odometry, draw-independent.  Poses: the identity minimizer
    returns the prior, so they agree to f32 rounding.  Map: counts within
    0.5 % (a point on a voxel face or within an ulp of a gate may fall
    either way) and 99 % of points within 1e-4 m of a point of the other
    map."""
    world = make_world(rng)
    mj, mt = drive_both(bundled("config.yaml", True), world,
                        [2.0, 2.5, 3.0, 3.5, 4.0], noise=0.02)
    for pj, pt in zip(mj.get_trajectory().poses, mt.get_trajectory().poses):
        np.testing.assert_allclose(pt, pj, atol=1e-5)
    assert_maps_close(mj.get_map(), mt.get_map(), 0.005)
    gt = mt.get_map()
    np.testing.assert_allclose(np.linalg.norm(gt["normals"], axis=1), 1.0,
                               atol=1e-4)
    assert ((gt["probabilityDynamic"] >= 0)
            & (gt["probabilityDynamic"] <= 1)).all()
    assert len(mt.get_trajectory()) == 5
    assert float(mt.overlap) == pytest.approx(float(mj.overlap), abs=1e-4)


def test_identity_config_2d(rng):
    """The same chain at D=2: a room outline, sampled."""
    n = 160
    u = lambda lo, hi: rng.uniform(lo, hi, size=n).astype(np.float32)
    c = lambda v: np.full(n, v, np.float32)
    world = np.concatenate([np.column_stack(w) for w in [
        (u(0, 14, ), c(-3)), (u(0, 14), c(3)), (c(0), u(-3, 3)),
        (c(14), u(-3, 3)), (c(9), u(-1, 1))]])
    mj, mt = drive_both(bundled("config.yaml", True), world,
                        [3.0, 3.5, 4.0, 4.5], noise=0.0, is_3d=False)
    np.testing.assert_allclose(mt.get_pose(), mj.get_pose(), atol=1e-5)
    ga, gb = mj.get_map(), mt.get_map()
    assert gb["positions"].shape[1] == 2
    assert_maps_close(ga, gb, 0.005)


# ---------------------------------------------------------------- p2plane

def _jax_state(mj):
    """The reference mapper's state after drain(), as numpy."""
    local = mj.map.local
    arrays = (np.asarray(local.positions), np.asarray(local.mask),
              {k: np.asarray(v) for k, v in local.descriptors.items()})
    cells = {cid: mj.map.cell_manager.retrieve_cell(cid)
             for cid in mj.map.cell_manager.get_all_cell_ids()}
    return dict(map_arrays=arrays, pose=mj.get_pose(),
                last_pose=mj.last_pose_where_map_was_updated,
                last_time_ns=mj.last_time_map_was_updated,
                window=mj.map._window,
                loaded_cell_ids=set(mj.map.loaded_cell_ids), cells=cells)


def test_p2plane_config_exact_step_locked(rng):
    """Perturbed priors that ICP really corrects.  Every scan starts from
    the SAME state in both packages (the reference's, carried over by
    ``convert.mapper_state_from_numpy``), so the comparison is not blurred
    by what a cut at the dynamic-probability threshold does to later scans.
    Poses within 1e-4 (both solvers walk the same iterations in f32 and stop
    on the same one); map counts within 0.5 %; 99 % of points within 1e-4 m
    plus the pose difference."""
    world = make_world(rng)
    cfg = bundled("config_p2plane.yaml", True)
    mj = nj.Mapper(copy.deepcopy(cfg))
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    nrng = np.random.default_rng(1)
    iters = []
    for i, x in enumerate([2.0, 2.5, 3.0, 3.5, 4.0]):
        true = pose_at(x)
        prior = true.copy()
        if i > 0:
            prior[:3, 3] += nrng.normal(size=3).astype(np.float32) * 0.05
        scan = scan_at(world, true)
        if i > 0:
            convert.mapper_state_from_numpy(mt, **_jax_state(mj))
        feed(mj, nj.PointBatch, scan, prior, i * int(1e8))
        mj.drain()
        feed(mt, nt.PointBatch, scan, prior, i * int(1e8), device="cpu")
        iters.append(mt.last_iterations)
        np.testing.assert_allclose(mt.get_pose(), mj.get_pose(), atol=1e-4)
        if i > 0:
            # the prior was off by ~5 cm; ICP brings it back
            assert np.linalg.norm(mt.get_pose()[:3, 3] - true[:3, 3]) < 0.03
        assert_maps_close(mj.get_map(), mt.get_map(), 0.005, nn_tol=2e-4)
    assert min(iters[1:]) > 1  # the solver really iterated


def test_p2plane_config_exact_free_running(rng):
    """The same drive with each package carrying its own state over five
    scans: poses within 1e-4 (the tolerance of one solve, see above; they
    do not drift apart), counts within 0.5 %, 99 % of points within 1e-4 m
    plus the pose tolerance."""
    world = make_world(rng)
    mj, mt = drive_both(bundled("config_p2plane.yaml", True), world,
                        [2.0, 2.5, 3.0, 3.5, 4.0], noise=0.05)
    for pj, pt in zip(mj.get_trajectory().poses, mt.get_trajectory().poses):
        np.testing.assert_allclose(pt, pj, atol=1e-4)
    assert_maps_close(mj.get_map(), mt.get_map(), 0.005, nn_tol=2e-4)


@pytest.mark.parametrize("name", ["config.yaml", "config_p2plane.yaml"])
def test_bundled_configs_with_the_reference_draws(rng, name):
    """The bundled files unmodified (random voxel sampling, a reading
    filter that keeps half the points), the port fed the reference's own
    draws: the same computation, so the same bounds as the exact runs --
    poses within 1e-4, counts within 0.5 %, 99 % of points within 1e-4 m
    plus the pose tolerance, occupied 0.15 m voxels agreeing to 98 %."""
    world = make_world(rng)
    mj, mt = drive_both(f"examples/{name}", world, [2.0, 2.5, 3.0, 3.5],
                        noise=0.03, draw_source=ReferenceDraws())
    for pj, pt in zip(mj.get_trajectory().poses, mt.get_trajectory().poses):
        np.testing.assert_allclose(pt, pj, atol=1e-4)
    ga, gb = mj.get_map(), mt.get_map()
    assert_maps_close(ga, gb, 0.005, nn_tol=2e-4)
    assert voxel_agreement(ga["positions"], gb["positions"]) >= 0.98


@pytest.mark.parametrize("name,pose_tol,vox_share", [
    ("config.yaml", 1e-5, 0.98), ("config_p2plane.yaml", 2.5e-2, 0.85)])
def test_bundled_configs_with_own_draws(rng, name, pose_tol, vox_share):
    """The bundled files unmodified, the port drawing from its own seeded
    generator: other voxel representatives and, for point-to-plane, another
    random half of each ~800-point reading.  Identity: poses are the
    priors; map count within 2 %, occupied 0.15 m voxels agreeing to 98 %.
    Point-to-plane: registration of half a sparse scan is itself good to
    about a centimetre on this world, so two samplings agree to about that
    -- poses within 2.5e-2 of each other and 3e-2 of the truth, count
    within 2 %, voxels agreeing to 85 % (points shifted by a centimetre
    change voxel when within a centimetre of a face)."""
    world = make_world(rng)
    xs = [2.0, 2.5, 3.0, 3.5]
    mj, mt = drive_both(f"examples/{name}", world, xs, noise=0.03)
    for x, pj, pt in zip(xs, mj.get_trajectory().poses,
                         mt.get_trajectory().poses):
        np.testing.assert_allclose(pt, pj, atol=pose_tol)
        if "p2plane" in name:
            assert np.abs(pt[:3, 3] - pose_at(x)[:3, 3]).max() < 3e-2
    ga, gb = mj.get_map()["positions"], mt.get_map()["positions"]
    assert abs(len(ga) - len(gb)) <= 0.02 * max(len(ga), len(gb))
    assert voxel_agreement(ga, gb) >= vox_share


def test_octree_draws_reach_the_merge(rng):
    """``draw_source`` replaces the generator at the octree's site."""
    world = make_world(rng)
    asked = []

    def source(site, n):
        asked.append((site, n))
        return octree_draws(site, n)

    mt = nt.Mapper("examples/config.yaml", device="cpu", draw_source=source)
    for i, x in enumerate([2.0, 2.5]):
        feed(mt, nt.PointBatch, scan_at(world, pose_at(x)), pose_at(x),
             i * int(1e8), device="cpu")
    assert [s for s, _ in asked] == [SITE_OCTREE_PRIO] * 2
    # both merges decimate the union [map; scan]: map capacity + scan's
    scan_cap = nt.bucket_capacity(scan_at(world, pose_at(2.5)).shape[0])
    assert asked[1][1] == mt.map.local.capacity + scan_cap


# ----------------------------------------------------------- rolling window

def test_rolling_window_matches(rng):
    """A drive that crosses cell boundaries with a 15 m sensor range: cells
    are evicted behind the robot in both packages, and the global cloud
    (local + saved cells) is the same."""
    n = 4000
    x = rng.uniform(0, 300, n).astype(np.float32)
    side = rng.integers(0, 3, n)
    world = np.column_stack([
        x, np.where(side == 0, -3.0, np.where(side == 1, 3.0,
                                              rng.uniform(-3, 3, n))),
        np.where(side == 2, 0.0, rng.uniform(0, 2, n))]).astype(np.float32)
    cfg = bundled("config.yaml", True)
    cfg["mapper"]["sensorMaxRange"] = 15
    mj = nj.Mapper(copy.deepcopy(cfg))
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    for i, xr in enumerate(np.arange(2.0, 160.0, 10.0)):
        pose = pose_at(xr)
        scan = scan_at(world, pose, 15.0)
        feed(mj, nj.PointBatch, scan, pose, i * int(1e8))
        feed(mt, nt.PointBatch, scan, pose, i * int(1e8), device="cpu")
    mj.drain()
    ids_j = sorted(mj.map.cell_manager.get_all_cell_ids())
    ids_t = sorted(mt.map.cell_manager.get_all_cell_ids())
    assert len(ids_t) > 0 and ids_t == ids_j
    assert mt.map._window == mj.map._window
    assert mt.map.loaded_cell_ids == mj.map.loaded_cell_ids
    gj, gt = mj.get_map(), mt.get_map()
    assert gt["positions"].shape[0] > mt.map.known_count()
    assert_maps_close(gj, gt, 0.005)
    # the local cloud holds only the window
    local = mt.map.local.to_numpy()["positions"]
    assert local[:, 0].min() > 152.0 - 15 - 5 * 20 - 1


# ------------------------------------------------------------ facade, config

def test_get_map_set_map_round_trip(rng):
    world = make_world(rng)
    cfg = bundled("config.yaml", True)
    mt = nt.Mapper(cfg, device="cpu")
    for i, x in enumerate([2.0, 2.5, 3.0]):
        feed(mt, nt.PointBatch, scan_at(world, pose_at(x)), pose_at(x),
             i * int(1e8), device="cpu")
    saved = mt.get_map()
    fresh = nt.Mapper(cfg, device="cpu", is_mapping=False)
    fresh.set_map(saved)
    assert len(fresh.get_trajectory()) == 0
    back = fresh.get_map()
    for k in saved:
        np.testing.assert_array_equal(back[k], saved[k])
    # localization on the restored map: no merge, the map stays as it is
    feed(fresh, nt.PointBatch, scan_at(world, pose_at(3.5)), pose_at(3.5),
         int(1e9), device="cpu")
    assert fresh.get_is_mapping() is False
    assert fresh.get_map()["positions"].shape == saved["positions"].shape
    assert 0.9 < float(fresh.overlap) <= 1.0
    assert fresh.get_new_local_map() is not None
    assert fresh.get_new_local_map() is None  # consume-once


SCHEMA_ERRORS = [
    ({"bogus": {}}, ValueError, "Invalid key: bogus"),
    ({"mapper": {"foo": 1}}, ValueError, "Invalid key: foo"),
    ({"mapper": {"updateCondition": {"type": "delay"}}}, ValueError,
     "Missing key: value"),
    ({"mapper": {"updateCondition": {"value": 1}}}, ValueError,
     "Missing key: type"),
    ({"mapper": {"updateCondition": {"type": "delay", "value": 1, "x": 2}}},
     ValueError, "Invalid key: x"),
    ({"mapper": {"updateCondition": {"type": "nope", "value": 1}}},
     ValueError, "Invalid map update condition: nope"),
    ({"mapper": {"updateCondition": {"type": "distance", "value": -1}}},
     ValueError, "Invalid map update distance"),
    ({"mapper": {"updateCondition": {"type": "overlap", "value": 2}}},
     ValueError, "Invalid map update overlap"),
    ({"mapper": {"updateCondition": {"type": "delay", "value": -2}}},
     ValueError, "Invalid map update delay"),
    ({"mapper": {"sensorMaxRange": -5}}, ValueError,
     "Invalid sensor max range"),
    ("/nonexistent/config.yaml", RuntimeError, "does not exist"),
]


@pytest.mark.parametrize("cfg,exc,match", SCHEMA_ERRORS,
                         ids=[str(i) for i in range(len(SCHEMA_ERRORS))])
def test_config_schema_errors_match_reference(cfg, exc, match):
    with pytest.raises(exc, match=match):
        nj.Mapper(copy.deepcopy(cfg))
    with pytest.raises(exc, match=match):
        nt.Mapper(copy.deepcopy(cfg), device="cpu")


def test_duplicate_yaml_key_rejected(tmp_path):
    path = tmp_path / "dup.yaml"
    path.write_text("mapper:\n  sensorMaxRange: 10\n  sensorMaxRange: 20\n")
    with pytest.raises(yaml.YAMLError, match="Duplicated key"):
        nt.Mapper(str(path), device="cpu")


def test_update_conditions(rng):
    world = make_world(rng)
    for cond, value, expect in [("distance", 0.4, [True, True, False, True]),
                                ("delay", 0.15, [True, False, True, False]),
                                ("overlap", 0.0, [True, False, False, False])]:
        cfg = bundled("config.yaml", True)
        cfg["mapper"]["updateCondition"] = {"type": cond, "value": value}
        mt = nt.Mapper(cfg, device="cpu")
        merged = []
        for i, x in enumerate([2.0, 2.5, 2.6, 3.1]):
            before = mt.last_time_map_was_updated
            feed(mt, nt.PointBatch, scan_at(world, pose_at(x)), pose_at(x),
                 i * int(1e8), device="cpu")
            merged.append(mt.last_time_map_was_updated != before)
        assert merged == expect, (cond, merged)


def test_queued_facade_features_raise_by_name(rng):
    # online mode is ported: the mapper starts its map-update worker and the
    # map's cell-update thread, and stops both at shutdown
    mo = nt.Mapper(None, is_online=True, device="cpu")
    assert mo.is_online and mo._executor is not None
    assert mo.map._update_thread is not None
    mo.shutdown()
    assert mo.map._update_thread is None
    # the sharded backend is ported (tests/test_torch_sharded_*.py); a
    # mesh must be a DeviceMesh
    with pytest.raises(TypeError, match="mesh"):
        nt.Mapper(None, mesh=object(), device="cpu")
    mt = nt.Mapper(None, device="cpu")  # the default config loads
    # keyframes are ported (tests/test_torch_pose_graph.py); the pose graph
    # needs three of them
    with pytest.raises(RuntimeError, match="need >= 3 keyframes"):
        mt.refine_trajectory()
    mt.enable_keyframes()
    assert mt.get_keyframes() is None and mt.keyframe_thinning_events == 0
    # the default config runs: the first scan bootstraps the map (k-NN
    # normals over it), the second registers against it and, 1.5 m on,
    # merges through PointDistanceMapperModule
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    feed(mt, nt.PointBatch, pts, np.eye(4, dtype=np.float32), 0, device="cpu")
    moved = np.eye(4, dtype=np.float32)
    moved[0, 3] = 1.5
    feed(mt, nt.PointBatch, pts - moved[:3, 3], moved, int(1e8), device="cpu")
    assert len(mt.get_trajectory()) == 2 and mt.last_iterations >= 1
    assert mt.map.known_count() >= 100
