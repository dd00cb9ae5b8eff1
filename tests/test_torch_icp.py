"""Port parity: ``ICPEngine`` against the JAX engine on a synthetic world
with a known offset (CPU).

On the CPU the JAX engine matches through its grid hash, which is exact at
these sizes; the port always matches through the sorted sweep (here its plain
version).  Both therefore see the same correspondences.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu import PointBatch as JBatch
from norlab_icp_mapper_tpu.icp.engine import ICPEngine as JEngine
from norlab_icp_mapper_tpu_torch import PointBatch as TBatch
from norlab_icp_mapper_tpu_torch.icp.engine import ICPEngine as TEngine


def make_world(rng, n=1500):
    """The corridor generator of the e2e tests (floor + two side walls),
    closed by two end walls and crossed by a partition: a bare corridor
    leaves the along-track translation unconstrained, and two solvers then
    differ by whatever the damping lets slide."""
    k = n // 6
    u = lambda lo, hi, m: rng.uniform(lo, hi, size=m).astype(np.float32)
    full = lambda v, m: np.full(m, v, np.float32)
    floor = np.column_stack([u(0, 20, 2 * k), u(-3, 3, 2 * k),
                             full(0, 2 * k)])
    wall1 = np.column_stack([u(0, 20, k), full(-3, k), u(0, 2, k)])
    wall2 = np.column_stack([u(0, 20, k), full(3, k), u(0, 2, k)])
    end1 = np.column_stack([full(0, k // 2), u(-3, 3, k // 2),
                            u(0, 2, k // 2)])
    end2 = np.column_stack([full(12, k // 2), u(-3, 3, k // 2),
                            u(0, 2, k // 2)])
    part = np.column_stack([full(8, k), u(-1, 1, k), u(0, 2, k)])
    return np.concatenate([floor, wall1, wall2, end1, end2, part])


def world_normals(world):
    """Analytic normals of make_world's planes."""
    n = np.zeros_like(world)
    on_floor = world[:, 2] == 0
    on_side = np.abs(np.abs(world[:, 1]) - 3) < 1e-6
    n[on_floor, 2] = 1
    n[~on_floor & on_side, 1] = 1
    n[~on_floor & ~on_side, 0] = 1
    return n.astype(np.float32)


def pose_at(x, yaw=0.0):
    c, s = np.cos(yaw), np.sin(yaw)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[0, 3] = x
    return T


def offset_3d():
    T = pose_at(0.0, yaw=0.02)
    T[:3, 3] = [0.06, -0.04, 0.03]
    return T


def _config(minimizer, extra=None):
    cfg = {
        "matcher": {"KDTreeMatcher": {"knn": 3, "maxDist": 1.0}},
        "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.9}}],
        "errorMinimizer": minimizer,
        "transformationCheckers": [
            {"CounterTransformationChecker": {"maxIterationCount": 30}},
            {"DifferentialTransformationChecker": {
                "minDiffRotErr": 1e-4, "minDiffTransErr": 1e-4,
                "smoothLength": 3}},
        ],
    }
    cfg.update(extra or {})
    return cfg


def _rot_angle(R):
    if R.shape[0] == 2:
        return abs(np.arctan2(R[1, 0], R[0, 0]))
    return np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))


def _run_both(cfg, ref_pts, ref_n, read_pts, dim, monkeypatch, rematch):
    # pinned BEFORE either engine is built: the JAX engine caches its
    # compiled solve without the environment in the key
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", str(rematch))
    ej, et = JEngine(dict(cfg), dim=dim), TEngine(dict(cfg), dim=dim)
    ej.set_map(JBatch.from_numpy(ref_pts, {"normals": ref_n}))
    et.set_map(TBatch.from_numpy(ref_pts, {"normals": ref_n}, device="cpu"))
    rj = ej(JBatch.from_numpy(read_pts))
    rt = et(TBatch.from_numpy(read_pts, device="cpu"))
    return rj, rt, et


@pytest.mark.parametrize("rematch", [1, 3])
def test_point_to_plane_3d(rng, monkeypatch, rematch):
    world = make_world(rng)
    normals = world_normals(world)
    off = offset_3d()
    # the reading is the world seen through a wrong prior: the correction
    # that registers it is off^-1
    reading = (world[::2] @ off[:3, :3].T + off[:3, 3]).astype(np.float32)
    rj, rt, et = _run_both(_config("PointToPlaneErrorMinimizer"), world,
                           normals, reading, 3, monkeypatch, rematch)
    Tj, Tt = np.asarray(rj.correction), rt.correction.numpy()
    assert int(et.last_overflow) == 0
    # both solvers walk the same iterations in f32: 1e-3 m / 1e-3 rad
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 1e-3
    assert _rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) < 1e-3
    assert abs(int(rj.iterations) - rt.iterations) <= 1
    assert abs(float(rj.overlap) - float(rt.overlap)) < 1e-3
    assert abs(float(rj.residual) - float(rt.residual)) < 1e-3
    # and the port really recovers the offset
    rec = Tt @ off
    assert np.linalg.norm(rec[:3, 3]) < 5e-3
    assert _rot_angle(rec[:3, :3]) < 2e-3
    assert rt.iterations > 1


@pytest.mark.parametrize("rematch", [1, 3])
def test_point_to_plane_2d(rng, monkeypatch, rematch):
    # a closed 2-D room: four walls and a partition
    n = 250
    u = lambda lo, hi: rng.uniform(lo, hi, size=n).astype(np.float32)
    c = lambda v: np.full(n, v, np.float32)
    walls = [(u(0, 10), c(-3)), (u(0, 10), c(3)), (c(0), u(-3, 3)),
             (c(10), u(-3, 3)), (c(6), u(-1, 1))]
    world = np.concatenate([np.column_stack(w) for w in walls])
    normals = np.zeros_like(world)
    horiz = np.abs(np.abs(world[:, 1]) - 3) < 1e-6
    normals[horiz, 1] = 1
    normals[~horiz, 0] = 1
    yaw = 0.015
    R = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]],
                 np.float32)
    t = np.array([0.05, -0.03], np.float32)
    reading = (world[::2] @ R.T + t).astype(np.float32)
    rj, rt, _ = _run_both(_config("PointToPlaneErrorMinimizer"), world,
                          normals, reading, 2, monkeypatch, rematch)
    Tj, Tt = np.asarray(rj.correction), rt.correction.numpy()
    assert Tt.shape == (3, 3)
    assert np.linalg.norm(Tj[:2, 2] - Tt[:2, 2]) < 1e-3
    assert _rot_angle(Tj[:2, :2].T @ Tt[:2, :2]) < 1e-3
    assert abs(int(rj.iterations) - rt.iterations) <= 1
    assert abs(float(rj.overlap) - float(rt.overlap)) < 1e-3
    off = np.eye(3, dtype=np.float32)
    off[:2, :2], off[:2, 2] = R, t
    rec = Tt @ off
    assert np.linalg.norm(rec[:2, 2]) < 5e-3


@pytest.mark.parametrize("dim", [2, 3])
def test_identity_minimizer(rng, monkeypatch, dim):
    world = make_world(rng, 900)[:, :dim]
    normals = np.zeros_like(world)
    reading = world[::3] + np.float32(0.05)
    # push a fifth of the reading out of the matcher's reach
    reading[::5] += np.float32(50.0)
    cfg = _config("IdentityErrorMinimizer", {
        "matcher": {"KDTreeMatcher": {"knn": 6, "maxDist": 0.5}},
        "outlierFilters": []})
    rj, rt, _ = _run_both(cfg, world, normals, reading, dim, monkeypatch, 3)
    np.testing.assert_array_equal(rt.correction.numpy(), np.eye(dim + 1))
    np.testing.assert_array_equal(np.asarray(rj.correction), np.eye(dim + 1))
    assert rt.iterations == int(rj.iterations) == 1
    assert abs(float(rt.overlap) - float(rj.overlap)) < 1e-6
    assert 0.7 < float(rt.overlap) < 0.9


def test_max_dist_outlier_filter(rng, monkeypatch):
    world = make_world(rng)
    off = offset_3d()
    reading = (world[::2] @ off[:3, :3].T + off[:3, 3]).astype(np.float32)
    cfg = _config("PointToPlaneErrorMinimizer", {
        "outlierFilters": [{"MaxDistOutlierFilter": {"maxDist": 0.5}}]})
    rj, rt, _ = _run_both(cfg, world, world_normals(world), reading, 3,
                          monkeypatch, 1)
    Tj, Tt = np.asarray(rj.correction), rt.correction.numpy()
    assert np.linalg.norm(Tj[:3, 3] - Tt[:3, 3]) < 1e-3
    assert _rot_angle(Tj[:3, :3].T @ Tt[:3, :3]) < 1e-3


def test_config_parsing_matches_reference():
    for cfg in (None, _config("PointToPlaneErrorMinimizer"),
                _config("IdentityErrorMinimizer")):
        ej, et = JEngine(cfg), TEngine(cfg)
        for attr in ("match_knn", "match_max_dist", "outlier_filters",
                     "minimizer", "max_iter", "diff_checker"):
            assert getattr(ej, attr) == getattr(et, attr), attr
        assert len(ej.reading_filters) == len(et.reading_filters)
        assert len(ej.reference_filters) == len(et.reference_filters)


@pytest.mark.parametrize("cfg,match", [
    ({"bogus": 1}, "unknown section 'bogus'"),
    ({"matcher": {"OtherMatcher": {}}}, "unknown matcher"),
    ({"matcher": {"KDTreeMatcher": {"foo": 1}}}, "unknown params"),
    ({"outlierFilters": [{"NopeFilter": {}}]}, "unknown outlier filter"),
    ({"errorMinimizer": "NopeMinimizer"}, "unknown errorMinimizer"),
    ({"transformationCheckers": [{"NopeChecker": {}}]},
     "unknown transformation checker"),
    ({"inspector": "NopeInspector"}, "unknown inspector"),
])
def test_config_errors_match_reference(cfg, match):
    with pytest.raises(ValueError, match=match):
        JEngine(cfg)
    with pytest.raises(ValueError, match=match):
        TEngine(cfg)


@pytest.mark.parametrize("cfg,match", [
    ({"errorMinimizer": "PointToPointErrorMinimizer"},
     "PointToPointErrorMinimizer"),
    ({"outlierFilters": [{"MedianDistOutlierFilter": {}}]},
     "MedianDistOutlierFilter"),
    ({"outlierFilters": [{"SurfaceNormalOutlierFilter": {}}]},
     "SurfaceNormalOutlierFilter"),
    ({"transformationCheckers": [{"BoundTransformationChecker": {}}]},
     "BoundTransformationChecker"),
    ({"readingStepDataPointsFilters": ["IdentityDataPointsFilter"]},
     "readingStepDataPointsFilters"),
    ({"inspector": "VTKFileInspector"}, "VTKFileInspector"),
    ({"inspector": "PerformanceInspector"}, "PerformanceInspector"),
])
def test_queued_features_raise_by_name(cfg, match):
    with pytest.raises(NotImplementedError, match=match):
        TEngine(cfg)


def test_matcher_without_max_dist_and_missing_pieces(rng):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    eng = TEngine({"matcher": {"KDTreeMatcher": {"knn": 1}},
                   "errorMinimizer": "IdentityErrorMinimizer"})
    with pytest.raises(RuntimeError, match="set_map"):
        eng(TBatch.from_numpy(pts, device="cpu"))
    eng.set_map(TBatch.from_numpy(pts, device="cpu"))
    assert eng.has_map()
    with pytest.raises(NotImplementedError, match="without maxDist"):
        eng(TBatch.from_numpy(pts, device="cpu"))
    eng.clear_map()
    assert not eng.has_map()
    p2p = TEngine(_config("PointToPlaneErrorMinimizer"))
    p2p.set_map(TBatch.from_numpy(pts, device="cpu"))
    with pytest.raises(ValueError, match="requires 'normals'"):
        p2p(TBatch.from_numpy(pts, device="cpu"))
