"""Port parity: ``ICPEngine`` against the JAX engine on a synthetic world
with a known offset (CPU).

On the CPU the JAX engine matches through its grid hash (with ``maxDist``) or
its XLA brute-force search (without), both exact at these sizes; the port
matches through the sorted sweep or its own brute-force search (here their
plain versions).  Both therefore see the same correspondences, up to pairs
that tie within the rounding of the reference's expanded-form distance.
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu import PointBatch as JBatch
from norlab_icp_mapper_tpu.icp.engine import ICPEngine as JEngine
from norlab_icp_mapper_tpu_torch import PointBatch as TBatch
from norlab_icp_mapper_tpu_torch import DrawSource
from norlab_icp_mapper_tpu_torch.icp.engine import ICPEngine as TEngine
from norlab_icp_mapper_tpu_torch.draws import SITE_RANDOM_SAMPLING


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


def _engines(cfg, ref_pts, ref_n, dim, monkeypatch, rematch):
    # pinned BEFORE either engine is built: the JAX engine caches its
    # compiled solve without the environment in the key
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", str(rematch))
    ej, et = JEngine(dict(cfg), dim=dim), TEngine(dict(cfg), dim=dim)
    ej.set_map(JBatch.from_numpy(ref_pts, {"normals": ref_n}))
    et.set_map(TBatch.from_numpy(ref_pts, {"normals": ref_n}, device="cpu"))
    return ej, et


def _run_both(cfg, ref_pts, ref_n, read_pts, dim, monkeypatch, rematch,
              draws=None):
    ej, et = _engines(cfg, ref_pts, ref_n, dim, monkeypatch, rematch)
    rj = ej(JBatch.from_numpy(read_pts))
    rt = et(TBatch.from_numpy(read_pts, device="cpu"), draws)
    return rj, rt, et


def _room_2d(rng, n=250):
    """A closed 2-D room: four walls and a partition, with its normals."""
    u = lambda lo, hi: rng.uniform(lo, hi, size=n).astype(np.float32)
    c = lambda v: np.full(n, v, np.float32)
    walls = [(u(0, 10), c(-3)), (u(0, 10), c(3)), (c(0), u(-3, 3)),
             (c(10), u(-3, 3)), (c(6), u(-1, 1))]
    world = np.concatenate([np.column_stack(w) for w in walls])
    normals = np.zeros_like(world)
    horiz = np.abs(np.abs(world[:, 1]) - 3) < 1e-6
    normals[horiz, 1] = 1
    normals[~horiz, 0] = 1
    return world, normals


def _offset(dim):
    if dim == 3:
        return offset_3d()
    yaw = 0.015
    T = np.eye(3, dtype=np.float32)
    T[:2, :2] = [[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]]
    T[:2, 2] = [0.05, -0.03]
    return T


def _scene(rng, dim):
    """World, normals, the offset, and a reading seen through it."""
    if dim == 3:
        world = make_world(rng)
        normals = world_normals(world)
    else:
        world, normals = _room_2d(rng)
    off = _offset(dim)
    reading = (world[::2] @ off[:dim, :dim].T + off[:dim, dim]
               ).astype(np.float32)
    return world, normals, off, reading


def _assert_same_registration(rj, rt, dim, tol=1e-3):
    """Both solvers walk the same iterations in f32: ``tol`` m and rad."""
    Tj, Tt = np.asarray(rj.correction), rt.correction.numpy()
    assert Tt.shape == (dim + 1, dim + 1)
    assert np.linalg.norm(Tj[:dim, dim] - Tt[:dim, dim]) < tol
    assert _rot_angle(Tj[:dim, :dim].T @ Tt[:dim, :dim]) < tol
    assert abs(int(rj.iterations) - rt.iterations) <= 1
    assert abs(float(rj.overlap) - float(rt.overlap)) < 1e-3
    assert abs(float(rj.residual) - float(rt.residual)) < 1e-3
    return Tt


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
    full = _config("PointToPointErrorMinimizer", {
        "matcher": {"KDTreeMatcher": {"knn": 2, "epsilon": 1}},
        "outlierFilters": [{"MedianDistOutlierFilter": {"factor": 2.5}},
                           {"SurfaceNormalOutlierFilter": {"maxAngle": 1.0}},
                           {"MedianDistOutlierFilter": {}},
                           {"SurfaceNormalOutlierFilter": {}}],
        "transformationCheckers": [
            {"CounterTransformationChecker": {"maxIterationCount": 7}},
            {"BoundTransformationChecker": {"maxRotationNorm": 0.3}}],
        "readingStepDataPointsFilters": [
            {"RandomSamplingDataPointsFilter": {"prob": 0.5}}]})
    for cfg in (None, _config("PointToPlaneErrorMinimizer"),
                _config("IdentityErrorMinimizer"), full):
        ej, et = JEngine(cfg), TEngine(cfg)
        assert len(ej.reading_step_filters) == len(et.reading_step_filters)
        for attr in ("match_knn", "match_max_dist", "outlier_filters",
                     "minimizer", "max_iter", "diff_checker",
                     "bound_checker"):
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


@pytest.mark.parametrize("rematch", [1, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_unbounded_matcher(rng, monkeypatch, dim, rematch):
    """A KDTreeMatcher without ``maxDist``: brute-force k-NN in both
    packages, no sweep pack and no sorted reading, ``overflow`` stays 0.
    Iterations within 1, pose within 1e-3 m / 1e-3 rad (a pair whose two
    nearest references tie within the reference's distance rounding may
    match the other one)."""
    world, normals, off, reading = _scene(rng, dim)
    cfg = _config("PointToPlaneErrorMinimizer",
                  {"matcher": {"KDTreeMatcher": {"knn": 3}}})
    rj, rt, et = _run_both(cfg, world, normals, reading, dim, monkeypatch,
                           rematch)
    from norlab_icp_mapper_tpu_torch.ops.nn import KnnPack
    assert isinstance(et._ref_pack, KnnPack)
    assert int(et.last_overflow) == 0
    Tt = _assert_same_registration(rj, rt, dim)
    rec = Tt @ off
    assert np.linalg.norm(rec[:dim, dim]) < 5e-3
    assert _rot_angle(rec[:dim, :dim]) < 2e-3
    assert rt.iterations > 1
    assert float(rt.overlap) == 1.0  # without a radius every point matches


@pytest.mark.parametrize("max_dist", [1.0, None])
@pytest.mark.parametrize("dim", [2, 3])
def test_point_to_point(rng, monkeypatch, dim, max_dist):
    """PointToPointErrorMinimizer: weighted Kabsch.  The port reduces the
    pairs' moments on the clouds' device and takes the DxD SVD on the host,
    the reference does both in its compiled loop; the reading is an exact
    rigid copy, so both converge onto the offset.  The rotation stop is
    2e-3 rad here: the rotation out of an SVD carries f32 rounding on its
    diagonal, and ``acos((trace - 1) / 2)`` turns one ulp below 1 into
    3.5e-4 rad, so a stop at 1e-4 rad would be decided by rounding in
    either package."""
    world, normals, off, reading = _scene(rng, dim)
    matcher = {"knn": 1} if max_dist is None else {"knn": 1,
                                                   "maxDist": max_dist}
    cfg = _config("PointToPointErrorMinimizer",
                  {"matcher": {"KDTreeMatcher": matcher}})
    cfg["transformationCheckers"][1] = {"DifferentialTransformationChecker": {
        "minDiffRotErr": 2e-3, "minDiffTransErr": 1e-4, "smoothLength": 3}}
    rj, rt, _ = _run_both(cfg, world, normals, reading, dim, monkeypatch, 1)
    Tt = _assert_same_registration(rj, rt, dim)
    rec = Tt @ off
    assert np.linalg.norm(rec[:dim, dim]) < 5e-3
    assert _rot_angle(rec[:dim, :dim]) < 2e-3
    assert rt.iterations > 2
    assert rt.correction.device.type == "cpu"


@pytest.mark.parametrize("factor", [1.5, 3.0])
def test_median_dist_outlier_filter(rng, monkeypatch, factor):
    """Pairs beyond ``factor^2`` times the median d2 get weight 0.  With 3
    neighbours per point the pair count is even or odd as it falls; the
    median is the mean of the two middle values in both packages."""
    world, normals, off, reading = _scene(rng, 3)
    cfg = _config("PointToPlaneErrorMinimizer", {
        "outlierFilters": [{"MedianDistOutlierFilter": {"factor": factor}}]})
    rj, rt, _ = _run_both(cfg, world, normals, reading, 3, monkeypatch, 1)
    _assert_same_registration(rj, rt, 3)
    # a reading with one point less: the other parity of the pair count
    rj, rt, _ = _run_both(cfg, world, normals, reading[:-1], 3, monkeypatch,
                          1)
    _assert_same_registration(rj, rt, 3)


def test_median_matches_nanmedian_for_even_and_odd_counts(rng):
    """The filter's median against ``jnp.nanmedian`` directly, through a
    one-iteration solve whose residual depends on which pairs survive."""
    for n in (40, 41):
        ref = rng.uniform(-2, 2, size=(60, 3)).astype(np.float32)
        read = (ref[:n] + rng.normal(scale=0.05, size=(n, 3))
                ).astype(np.float32)
        nrm = np.tile(np.float32([0, 0, 1]), (60, 1))
        cfg = {"matcher": {"KDTreeMatcher": {"knn": 1}},
               "outlierFilters": [{"MedianDistOutlierFilter": {"factor": 1.0}}],
               "errorMinimizer": "PointToPlaneErrorMinimizer",
               "transformationCheckers": [
                   {"CounterTransformationChecker": {"maxIterationCount": 1}}]}
        ej, et = JEngine(dict(cfg)), TEngine(dict(cfg))
        ej.set_map(JBatch.from_numpy(ref, {"normals": nrm}, capacity=64))
        et.set_map(TBatch.from_numpy(ref, {"normals": nrm}, capacity=64,
                                     device="cpu"))
        rj = ej(JBatch.from_numpy(read, capacity=64))
        rt = et(TBatch.from_numpy(read, capacity=64, device="cpu"))
        # factor 1: exactly the pairs at or below the median keep weight 1,
        # so a median taken as the lower middle value would drop one pair
        # for an even count and change the residual
        assert float(rt.residual) == pytest.approx(float(rj.residual),
                                                   abs=1e-6)
        np.testing.assert_allclose(rt.correction.numpy(),
                                   np.asarray(rj.correction), atol=1e-5)


@pytest.mark.parametrize("max_angle", [0.6, 1.2])
def test_surface_normal_outlier_filter(rng, monkeypatch, max_angle):
    """Pairs whose reference normal makes more than ``maxAngle`` with the
    reading point's ray (from the map origin, as the reference computes it)
    get weight 0."""
    world, normals, off, reading = _scene(rng, 3)
    cfg = _config("PointToPlaneErrorMinimizer", {
        "outlierFilters": [
            {"SurfaceNormalOutlierFilter": {"maxAngle": max_angle}}]})
    rj, rt, _ = _run_both(cfg, world, normals, reading, 3, monkeypatch, 1)
    _assert_same_registration(rj, rt, 3)
    # the filter needs normals on the reference even under point-to-point
    p2p = TEngine(_config("PointToPointErrorMinimizer", {
        "outlierFilters": [{"SurfaceNormalOutlierFilter": {}}]}))
    p2p.set_map(TBatch.from_numpy(world, device="cpu"))
    with pytest.raises(ValueError, match="requires 'normals'"):
        p2p(TBatch.from_numpy(reading, device="cpu"))


@pytest.mark.parametrize("dim", [2, 3])
def test_bound_checker_stops_and_throws_like_the_reference(rng, monkeypatch,
                                                           dim):
    world, normals, off, reading = _scene(rng, dim)

    def cfg(max_rot, max_trans):
        c = _config("PointToPlaneErrorMinimizer")
        c["transformationCheckers"] = c["transformationCheckers"] + [
            {"BoundTransformationChecker": {"maxRotationNorm": max_rot,
                                            "maxTranslationNorm": max_trans}}]
        return c

    # a generous bound changes nothing
    rj, rt, et = _run_both(cfg(0.5, 0.5), world, normals, reading, dim,
                           monkeypatch, 1)
    assert et.bound_checker == (0.5, 0.5)
    _assert_same_registration(rj, rt, dim)
    assert rt.iterations > 2
    # the offset is ~8 cm and ~0.02 rad: tighter bounds abort registration
    for bounds in [(0.5, 0.02), (0.005, 0.5)]:
        ej, et = _engines(cfg(*bounds), world, normals, dim, monkeypatch, 1)
        with pytest.raises(RuntimeError, match="BoundTransformationChecker"):
            ej(JBatch.from_numpy(reading))
        with pytest.raises(RuntimeError, match="BoundTransformationChecker"):
            et(TBatch.from_numpy(reading, device="cpu"))
        # the loop itself stopped at the first transform beyond the bound
        t = TBatch.from_numpy(reading, device="cpu")
        ref = et._ref
        T, _, iters, _ = et.solve(t.positions, t.mask, ref.positions,
                                  ref.descriptors["normals"], ref.mask,
                                  et._ref_pack)
        assert iters < 4


@pytest.mark.parametrize("rematch", [1, 3])
def test_step_filters_with_injected_draws(rng, monkeypatch, rematch):
    """readingStepDataPointsFilters: the reading is re-filtered at every
    matcher pass.  The reference draws from ``fold_in(PRNGKey(0), it)``,
    split once by the chain; the port is handed those very numbers through
    its ``DrawSource``.  The matcher has no ``maxDist``, so neither package
    reorders the reading and a draw meets the same point in both."""
    world, normals, off, reading = _scene(rng, 3)
    cfg = _config("PointToPlaneErrorMinimizer", {
        "matcher": {"KDTreeMatcher": {"knn": 1}},
        "readingStepDataPointsFilters": [
            {"RandomSamplingDataPointsFilter": {"prob": 0.6}}]})
    asked = []

    def source(site, n):
        assert site == SITE_RANDOM_SAMPLING
        it = len(asked) * rematch  # the passes run at it = 0, R, 2R, ...
        asked.append(n)
        key = jax.random.fold_in(jax.random.PRNGKey(0), it)
        _, sub = jax.random.split(key)
        return torch.from_numpy(np.array(jax.random.uniform(sub, (n,))))

    rj, rt, _ = _run_both(cfg, world, normals, reading, 3, monkeypatch,
                          rematch, draws=DrawSource(0, "cpu", source))
    _assert_same_registration(rj, rt, 3)
    assert len(asked) == -(-rt.iterations // rematch)
    # the overlap counts matched points among the valid ones: about prob
    assert 0.5 < float(rt.overlap) < 0.7


@pytest.mark.parametrize("rematch", [1, 3])
def test_step_filters_with_injected_draws_on_the_sorted_path(rng, monkeypatch,
                                                             rematch):
    """The injected-draws case with the default matcher (``knn: 3``,
    ``maxDist: 1.0``): the port sorts the reading by x inside the solve, the
    reference on the CPU does not.  The step chain runs on the moved reading
    in its original row order, so draw ``i`` lands on reading point ``i`` in
    both packages, and T agrees within 1e-5 (the same pairs, summed in
    another order)."""
    world, normals, off, reading = _scene(rng, 3)
    cfg = _config("PointToPlaneErrorMinimizer", {
        "readingStepDataPointsFilters": [
            {"RandomSamplingDataPointsFilter": {"prob": 0.6}}]})
    asked = []

    def source(site, n):
        assert site == SITE_RANDOM_SAMPLING
        it = len(asked) * rematch
        asked.append(n)
        key = jax.random.fold_in(jax.random.PRNGKey(0), it)
        _, sub = jax.random.split(key)
        return torch.from_numpy(np.array(jax.random.uniform(sub, (n,))))

    rj, rt, _ = _run_both(cfg, world, normals, reading, 3, monkeypatch,
                          rematch, draws=DrawSource(0, "cpu", source))
    _assert_same_registration(rj, rt, 3)
    np.testing.assert_allclose(rt.correction.numpy(),
                               np.asarray(rj.correction), atol=1e-5)
    assert int(rj.iterations) == rt.iterations
    assert len(asked) == -(-rt.iterations // rematch)


@pytest.mark.parametrize("matcher", [{"knn": 1}, {"knn": 3, "maxDist": 1.0}],
                         ids=["unbounded", "max_dist"])
@pytest.mark.parametrize("rematch", [1, 3])
def test_centroid_step_filter_moves_the_minimized_points(rng, monkeypatch,
                                                         rematch, matcher):
    """A step filter that moves points (``VoxelGrid`` with ``useCentroid``
    replaces each voxel's points by their centroid): without reuse both
    packages minimize on the stepped positions the pairs were matched
    from; with reuse (rematch 3) on the moved reading, unstepped.  The
    filter draws nothing, so T agrees within 1e-5 and the iterations are
    equal, with and without ``maxDist`` (the sorted path).  The scene is
    shifted off the 0.5 m voxel faces: its planes lie on them (the floor at
    z = 0), where a last-bit difference of T moves a whole plane's points
    into the next voxel."""
    world, normals, off, reading = _scene(rng, 3)
    shift = np.array([0.17, 0.11, 0.23], np.float32)
    world, reading = world + shift, reading + shift
    cfg = _config("PointToPlaneErrorMinimizer", {
        "matcher": {"KDTreeMatcher": dict(matcher)},
        "readingStepDataPointsFilters": [{"VoxelGridDataPointsFilter": {
            "vSizeX": 0.5, "vSizeY": 0.5, "vSizeZ": 0.5,
            "useCentroid": 1}}]})
    rj, rt, _ = _run_both(cfg, world, normals, reading, 3, monkeypatch,
                          rematch)
    np.testing.assert_allclose(rt.correction.numpy(),
                               np.asarray(rj.correction), atol=1e-5)
    assert int(rj.iterations) == rt.iterations
    assert abs(float(rj.residual) - float(rt.residual)) < 1e-5


def test_step_filters_without_draws_on_the_sorted_path(rng, monkeypatch):
    """A step filter that draws nothing (a bounding box in the map frame),
    with ``maxDist``: the port's reading is sorted along x inside the solve,
    the filter sees the moved points either way.  No reading point lies
    within half a metre of the box's face at x = 13: a point that crosses
    the face while the reading moves would flip in and out of the pair set,
    and rounding would then decide when either package stops."""
    world, normals, off, reading = _scene(rng, 3)
    reading = reading[np.abs(reading[:, 0] - 13.0) > 0.5]
    cfg = _config("PointToPlaneErrorMinimizer", {
        "readingStepDataPointsFilters": [{"BoundingBoxDataPointsFilter": {
            "xMin": 13.0, "xMax": 30.0, "yMin": -10, "yMax": 10, "zMin": -10,
            "zMax": 10, "removeInside": 1}}]})
    rj, rt, _ = _run_both(cfg, world, normals, reading, 3, monkeypatch, 3)
    _assert_same_registration(rj, rt, 3)
    assert 0.5 < float(rt.overlap) < 0.95  # the box really removes points


@pytest.mark.parametrize("cfg,match", [
    ({"inspector": "VTKFileInspector"}, "VTKFileInspector"),
    ({"inspector": "PerformanceInspector"}, "PerformanceInspector"),
])
def test_queued_features_raise_by_name(cfg, match):
    """The inspectors, once queued, are ported: each config builds its
    IterationInspector (only the VTK one dumps); an unknown name raises."""
    from norlab_icp_mapper_tpu_torch.utils.tracing import IterationInspector
    eng = TEngine(cfg)
    assert isinstance(eng.inspector, IterationInspector)
    assert (eng.inspector.dump_dir is None) == (match == "PerformanceInspector")
    with pytest.raises(ValueError, match="unknown inspector"):
        TEngine({"inspector": match + "X"})


def test_matcher_without_max_dist_and_missing_pieces(rng):
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    eng = TEngine({"matcher": {"KDTreeMatcher": {"knn": 1}},
                   "errorMinimizer": "IdentityErrorMinimizer"})
    with pytest.raises(RuntimeError, match="set_map"):
        eng(TBatch.from_numpy(pts, device="cpu"))
    eng.set_map(TBatch.from_numpy(pts, device="cpu"))
    assert eng.has_map()
    # without a radius every valid point finds a neighbour
    res = eng(TBatch.from_numpy(pts + 5.0, device="cpu"))
    assert float(res.overlap) == 1.0 and res.iterations == 1
    np.testing.assert_array_equal(res.correction.numpy(), np.eye(4))
    eng.clear_map()
    assert not eng.has_map()
    p2p = TEngine(_config("PointToPlaneErrorMinimizer"))
    p2p.set_map(TBatch.from_numpy(pts, device="cpu"))
    with pytest.raises(ValueError, match="requires 'normals'"):
        p2p(TBatch.from_numpy(pts, device="cpu"))
    # every step filter of the zoo is ported; an unknown one gets the
    # registry's error
    assert len(TEngine({"readingStepDataPointsFilters": [
        "IdentityDataPointsFilter"]}).reading_step_filters) == 1
    with pytest.raises(KeyError, match="unknown DataPointsFilter"):
        TEngine({"readingStepDataPointsFilters": ["NopeDataPointsFilter"]})
