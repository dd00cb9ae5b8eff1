"""Port parity: MapperModules against the JAX package (CPU)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu import PointBatch as JBatch
from norlab_icp_mapper_tpu.mapper_modules import core as jm
from norlab_icp_mapper_tpu_torch import PointBatch as TBatch, DrawSource
from norlab_icp_mapper_tpu_torch.mapper_modules import core as tm
from norlab_icp_mapper_tpu_torch.draws import SITE_OCTREE_PRIO

DYN_PARAMS = dict(thresholdDynamic=0.9, alpha=0.8, beta=0.99,
                  beamHalfAngle=0.01, epsilonA=0.01, epsilonD=0.01)


def _pose(x=1.0, yaw=0.3):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[:3, 3] = [x, -0.5, 0.2]
    return T


def _lidar_like(rng, n, shift=0.0):
    """Points on a sphere-ish shell around the origin, in the sensor frame."""
    az = rng.uniform(-np.pi, np.pi, n)
    el = rng.uniform(-0.4, 0.3, n)
    rad = rng.uniform(3, 12, n) + shift
    return np.column_stack([rad * np.cos(el) * np.cos(az),
                            rad * np.cos(el) * np.sin(az),
                            rad * np.sin(el)]).astype(np.float32)


def test_dynamic_points_bayes_elementwise(rng):
    m, s = 800, 300
    scan_s = _lidar_like(rng, s)
    map_s = _lidar_like(rng, m)
    scan_r = np.linalg.norm(scan_s, axis=1).astype(np.float32)
    map_r = np.linalg.norm(map_s, axis=1).astype(np.float32)
    nrm = rng.normal(size=(m, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    prob = rng.uniform(0, 1, m).astype(np.float32)
    idx = rng.integers(-1, s, m).astype(np.int32)
    d2 = np.where(idx >= 0, rng.uniform(0, 4e-4, m), np.inf).astype(np.float32)
    in_range = rng.random(m) < 0.9
    args = (0.9, 0.8, 0.99, 0.01, 0.01, 0.01)
    oj = jm.dynamic_points_bayes(
        jnp.asarray(scan_s), jnp.asarray(scan_r), jnp.asarray(map_s),
        jnp.asarray(map_r), jnp.asarray(nrm), jnp.asarray(prob),
        jnp.asarray(d2), jnp.asarray(idx), jnp.asarray(in_range), *args)
    ot = tm.dynamic_points_bayes(
        torch.from_numpy(scan_s), torch.from_numpy(scan_r),
        torch.from_numpy(map_s), torch.from_numpy(map_r),
        torch.from_numpy(nrm), torch.from_numpy(prob), torch.from_numpy(d2),
        torch.from_numpy(idx).long(), torch.from_numpy(in_range), *args)
    # elementwise f32 arithmetic, a handful of operations deep
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=2e-6)
    assert (ot.numpy() != prob).sum() > 100


def test_spherical_angles_match(rng):
    for dim in (2, 3):
        pts = _lidar_like(rng, 200)[:, :dim]
        r = np.linalg.norm(pts, axis=1).astype(np.float32)
        np.testing.assert_allclose(
            tm._spherical_angles(torch.from_numpy(pts),
                                 torch.from_numpy(r)).numpy(),
            np.asarray(jm._spherical_angles(jnp.asarray(pts),
                                            jnp.asarray(r))), atol=1e-6)


def test_dynamic_points_update_map(rng):
    """Scan and map of <= 1024 points: the angular sweep's window (W=1024)
    then holds every candidate, like the reference's CPU grid hash."""
    pose = _pose()
    map_sensor = _lidar_like(rng, 900)
    # the scan's beams pass through most map points (a map point in front
    # of its beam's return is evidence that it moved away) or stop short
    scan_sensor = (map_sensor[:700]
                   * rng.uniform(0.9, 1.3, (700, 1))).astype(np.float32)
    scan_sensor += rng.normal(scale=0.002, size=scan_sensor.shape
                              ).astype(np.float32)
    to_map = lambda p: (p @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    nrm = rng.normal(size=(900, 3)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mdesc = {"normals": nrm,
             "probabilityDynamic": np.full(900, 0.6, np.float32)}
    sdesc = {"probabilityDynamic": np.full(700, 0.6, np.float32)}
    oj = jm.mapper_module_registry.create(
        "DynamicPointsMapperModule", dict(DYN_PARAMS)).update_map(
            JBatch.from_numpy(to_map(scan_sensor), sdesc),
            JBatch.from_numpy(to_map(map_sensor), mdesc), jnp.asarray(pose))
    mod = tm.mapper_module_registry.create("DynamicPointsMapperModule",
                                           dict(DYN_PARAMS))
    ot = mod.update_map(
        TBatch.from_numpy(to_map(scan_sensor), sdesc, device="cpu"),
        TBatch.from_numpy(to_map(map_sensor), mdesc, device="cpu"),
        torch.from_numpy(pose))
    assert int(mod.last_overflow) == 0
    pj = np.asarray(oj.descriptors["probabilityDynamic"])[:900, 0]
    pt = ot.descriptors["probabilityDynamic"].numpy()[:900, 0]
    changed = pj != 0.6
    assert changed.sum() > 300
    # angles go through atan2/asin in f32 in both packages; a map beam whose
    # two nearest scan beams tie within that rounding may pick the other
    close = np.abs(pj - pt) < 1e-4
    assert close.mean() > 0.995
    assert ((pt != 0.6) == changed)[close].all()
    np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))


def test_dynamic_points_missing_descriptors(rng):
    mod = tm.mapper_module_registry.create("DynamicPointsMapperModule", {})
    pts = rng.normal(size=(20, 3)).astype(np.float32)
    plain = TBatch.from_numpy(pts, device="cpu")
    with pytest.raises(ValueError, match="probabilityDynamic"):
        mod.update_map(plain, plain, torch.eye(4))
    scan = TBatch.from_numpy(pts, {"probabilityDynamic": np.ones(20)},
                             device="cpu")
    with pytest.raises(ValueError, match="'normals'"):
        mod.update_map(scan, plain, torch.eye(4))


def _interior(rng, n, vox):
    cells = rng.integers(-8, 8, size=(n, 3))
    return ((cells + rng.uniform(0.05, 0.95, (n, 3))) * vox).astype(np.float32)


@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_octree_update_map(rng, method):
    vox = 0.5
    map_pts = _interior(rng, 600, vox)
    scan_pts = _interior(rng, 400, vox)
    params = dict(buildParallel=1, maxSizeByNode=vox, samplingMethod=method)
    mj = JBatch.from_numpy(map_pts, {"w": np.arange(600)}, capacity=1536)
    sj = JBatch.from_numpy(scan_pts, {"w": 1000 + np.arange(400)})
    mt = TBatch.from_numpy(map_pts, {"w": np.arange(600)}, capacity=1536,
                           device="cpu")
    st = TBatch.from_numpy(scan_pts, {"w": 1000 + np.arange(400)},
                           device="cpu")
    # the reference's merge passes no key: it draws from PRNGKey(0) at the
    # union's length; the port is handed those very numbers
    n_union = mj.capacity + sj.capacity
    prio = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (n_union,),
                                         0, 1 << 15, dtype=jnp.int32))
    asked = []

    def source(site, n):
        asked.append((site, n))
        return torch.from_numpy(prio.copy())

    oj = jm.mapper_module_registry.create(
        "OctreeMapperModule", dict(params)).update_map(sj, mj, jnp.eye(4))
    ot = tm.mapper_module_registry.create(
        "OctreeMapperModule", dict(params)).update_map(
            st, mt, torch.eye(4), DrawSource(0, "cpu", source))
    assert asked == ([(SITE_OCTREE_PRIO, n_union)] if method == 1 else [])
    np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
    np.testing.assert_array_equal(ot.descriptors["w"].numpy(),
                                  np.asarray(oj.descriptors["w"]))
    atol = 1e-5 if method == 2 else 0  # centroids: f32 segment sums
    np.testing.assert_allclose(ot.positions.numpy(),
                               np.asarray(oj.positions), atol=atol)
    # one survivor per occupied voxel of the union
    both = np.concatenate([map_pts, scan_pts])
    n_vox = len(np.unique(np.floor(both / vox).astype(np.int64), axis=0))
    assert int(ot.count()) == n_vox


def test_octree_create_map_and_passthrough(rng):
    pts = _interior(rng, 500, 0.5)
    params = dict(maxSizeByNode=0.5, samplingMethod=0)
    oj = jm.mapper_module_registry.create(
        "OctreeMapperModule", dict(params)).create_map(
            JBatch.from_numpy(pts), jnp.eye(4))
    ot = tm.mapper_module_registry.create(
        "OctreeMapperModule", dict(params)).create_map(
            TBatch.from_numpy(pts, device="cpu"), torch.eye(4))
    np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
    # maxSizeByNode 0: plain insert
    off = tm.mapper_module_registry.create("OctreeMapperModule", {})
    mt = TBatch.from_numpy(pts[:100], capacity=512, device="cpu")
    out = off.update_map(TBatch.from_numpy(pts[100:200], device="cpu"), mt,
                         torch.eye(4))
    assert int(out.count()) == 200


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("min_dist", [0.15, 0.4])
def test_point_distance_update_map(rng, dim, min_dist):
    """Scan points at 0 .. 2 minDist from their nearest map point.  The
    reference's CPU engine ranks by the expanded-form distance (error about
    ``eps * |x|^2`` ~ 2e-5 m^2 at these coordinates, i.e. below 1e-4 m in
    distance at the gate), so a decision may differ only where the true
    nearest distance lies within 1e-4 m of minDist; everywhere else the two
    packages keep the same points, in the same slots."""
    n_map, n_scan = 600, 400
    map_pts = rng.uniform(-6, 6, size=(n_map, dim)).astype(np.float32)
    step = rng.normal(size=(n_scan, dim))
    step *= (rng.uniform(0, 2 * min_dist, n_scan)
             / np.linalg.norm(step, axis=1))[:, None]
    scan_pts = (map_pts[rng.integers(0, n_map, n_scan)] + step
                ).astype(np.float32)
    scan_pts[:5] += 100.0  # far from everything: kept
    desc_m = {"w": np.arange(n_map)}
    desc_s = {"w": 1000 + np.arange(n_scan)}
    mj = JBatch.from_numpy(map_pts, desc_m, capacity=1280)
    mt = TBatch.from_numpy(map_pts, desc_m, capacity=1280, device="cpu")
    # some invalid slots on both sides
    holes_m = np.ones(1280, bool)
    holes_m[rng.integers(0, n_map, 40)] = False
    holes_s = np.ones(512, bool)
    holes_s[rng.integers(0, n_scan, 30)] = False
    sj = JBatch.from_numpy(scan_pts, desc_s, capacity=512)
    st = TBatch.from_numpy(scan_pts, desc_s, capacity=512, device="cpu")
    mj, sj = mj.with_mask(jnp.asarray(holes_m)), sj.with_mask(jnp.asarray(holes_s))
    mt = mt.with_mask(torch.from_numpy(holes_m))
    st = st.with_mask(torch.from_numpy(holes_s))
    params = {"minDistNewPoint": min_dist}
    oj = jm.mapper_module_registry.create(
        "PointDistanceMapperModule", dict(params)).update_map(
            sj, mj, jnp.eye(dim + 1))
    ot = tm.mapper_module_registry.create(
        "PointDistanceMapperModule", dict(params)).update_map(
            st, mt, torch.eye(dim + 1))
    # the decision per scan point, in float64 on the host
    valid_map = map_pts[holes_m[:n_map]]
    dist = np.sqrt(((scan_pts.astype(np.float64)[:, None]
                     - valid_map.astype(np.float64)[None]) ** 2).sum(-1)
                   ).min(1)
    alive = holes_s[:n_scan]
    border = alive & (np.abs(dist - min_dist) < 1e-4)
    expect = alive & (dist >= min_dist)
    kept_t = set(ot.descriptors["w"].numpy()[ot.mask.numpy(), 0].astype(int))
    kept_j = set(np.asarray(oj.descriptors["w"])[np.asarray(oj.mask), 0]
                 .astype(int))
    scan_ids = 1000 + np.arange(n_scan)
    sure = set(scan_ids[expect & ~border])
    maybe = set(scan_ids[border])
    map_ids = set(np.arange(n_map)[holes_m[:n_map]])
    assert 0.05 < expect.mean() < 0.95  # the gate really cuts
    assert map_ids | sure <= kept_t <= map_ids | sure | maybe
    assert len(kept_t ^ kept_j) <= len(maybe)
    assert set(scan_ids[:5]) <= kept_t  # no match within reach: kept
    if not (kept_t ^ kept_j):
        np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
        np.testing.assert_array_equal(ot.positions.numpy(),
                                      np.asarray(oj.positions))


def test_point_distance_into_an_empty_map_keeps_the_scan(rng):
    """No valid map point: every distance is inf, which counts as far."""
    pts = rng.normal(size=(100, 3)).astype(np.float32)
    mod = tm.mapper_module_registry.create("PointDistanceMapperModule", {})
    out = mod.update_map(TBatch.from_numpy(pts, device="cpu"),
                         TBatch.empty(256, 3, device="cpu"), torch.eye(4))
    assert int(out.count()) == 100
    np.testing.assert_array_equal(out.positions.numpy()[:100], pts)


def test_registry_and_queued_modules(rng):
    assert tm.mapper_module_registry.names() == \
        jm.mapper_module_registry.names()
    mod = tm.mapper_module_registry.create_from_yaml_entry(
        {"PointDistanceMapperModule": {"minDistNewPoint": 0.15}})
    assert mod.INSERTS == 1
    b = TBatch.from_numpy(rng.normal(size=(10, 3)).astype(np.float32),
                          device="cpu")
    # a cloud merged into itself adds nothing: every point has itself at 0
    assert int(mod.update_map(b, b.pad_to(512), torch.eye(4)).count()) == 10
    with pytest.raises(KeyError, match="unknown MapperModule"):
        tm.mapper_module_registry.create("NopeModule")
    with pytest.raises(ValueError, match="above maximum"):
        tm.mapper_module_registry.create("DynamicPointsMapperModule",
                                         {"alpha": 2.0})
    # maxPointByNode > 1 is ported: the JAX module's decimation of the same
    # cloud (tests/test_torch_octree_k.py holds the whole selection)
    params = dict(maxSizeByNode=0.5, maxPointByNode=4)
    octree = tm.mapper_module_registry.create("OctreeMapperModule", params)
    out_j = jm.mapper_module_registry.create(
        "OctreeMapperModule", params).create_map(
            JBatch(jnp.asarray(b.positions.numpy()),
                   jnp.asarray(b.mask.numpy())), jnp.eye(4))
    out_t = octree.create_map(b, torch.eye(4))
    np.testing.assert_array_equal(out_t.mask.numpy(), np.asarray(out_j.mask))
