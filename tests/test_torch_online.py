"""Online mode of the port's ``Mapper`` (``is_online=True``), on the CPU.

The JAX package runs an online scan as two device programs, ``register``
(solve and update condition) then ``merge``; the pose is an output of the
first, so ``get_pose()`` waits for the solve and not for the merge.  The
port enqueues the same two parts back to back on one stream and files the
pose's host copy between them.  Its stepwise path (bootstrap, bound
checker) merges on a single-worker executor, and the map applies its
rolling window's cell events on a background thread.  These tests port
``tests/test_online_fused.py`` and the online case of
``tests/test_rolling_window.py``, and hold the port against the JAX mapper.
"""
import copy

import numpy as np
import pytest

import norlab_icp_mapper_tpu as nj
import norlab_icp_mapper_tpu_torch as nt

from test_online_fused import CONFIG, make_world, poses_along_x, sensor_scan
from test_rolling_window import corridor_world, scan_at, small_range_config
from test_mapper_e2e import pose_at


def drive(mapper, pkg, world, poses, **kw):
    for i, pose in enumerate(poses):
        scan = sensor_scan(world, pose)
        filtered = mapper.apply_input_filters(
            pkg.PointBatch.from_numpy(scan, **kw))
        mapper.process_input(filtered, pose, int(1e9 + i * 1e8),
                             scan_valid_hint=scan.shape[0])
    return mapper


def _port(cfg, **kw):
    return nt.Mapper(copy.deepcopy(cfg), is_3d=True, device="cpu", **kw)


def test_online_split_matches_offline_fused(rng):
    """Online and offline give the same trajectory and map in the port
    (the same launches in the same order: bit for bit), and the port's
    online run matches the JAX package's within 2e-3 m: the k-NN normals
    of the two packages differ at rounding level, and eight point-to-plane
    iterations on this sparse world carry that into the poses (1e-3 m
    measured)."""
    world = make_world(rng)
    poses = poses_along_x(np.arange(1.0, 10.0, 1.5))
    off = drive(_port(CONFIG, is_online=False, seed=3), nt, world, poses,
                device="cpu")
    off.drain()
    on = drive(_port(CONFIG, is_online=True, seed=3), nt, world, poses,
               device="cpu")
    on.drain()
    ref = drive(nj.Mapper(copy.deepcopy(CONFIG), is_3d=True, is_online=True,
                          seed=3), nj, world, poses)
    ref.drain()

    t_off = np.stack(off.get_trajectory().poses)
    t_on = np.stack(on.get_trajectory().poses)
    t_ref = np.stack([np.asarray(p) for p in ref.get_trajectory().poses])
    np.testing.assert_array_equal(t_on, t_off)
    np.testing.assert_allclose(t_on, t_ref, rtol=0, atol=2e-3)

    m_off = off.get_map()["positions"]
    m_on = on.get_map()["positions"]
    m_ref = ref.get_map()["positions"]
    assert abs(m_off.shape[0] - m_on.shape[0]) <= 2
    assert abs(m_ref.shape[0] - m_on.shape[0]) <= 0.005 * m_ref.shape[0]
    for m in (on, off, ref):
        m.shutdown()


def test_online_pose_live_without_drain(rng):
    """The pose of the latest scan is readable mid-pipeline, before any
    drain: the scan's pose mirror was filed after its solve."""
    world = make_world(rng)
    poses = poses_along_x(np.arange(1.0, 6.0, 1.5))
    mapper = drive(_port(CONFIG, is_online=True, seed=0), nt, world, poses,
                   device="cpu")
    assert mapper._fused_state is not None  # nothing drained yet
    pose = mapper.get_pose()
    assert pose is not None and pose.shape == (4, 4)
    assert np.isfinite(pose).all()
    assert abs(pose[0, 3] - poses[-1][0, 3]) < 0.5
    mapper.drain()
    np.testing.assert_array_equal(mapper.get_pose(), pose)
    mapper.shutdown()


def test_failed_fused_step_leaves_clear_state(rng):
    """A failure in the middle of a scan's step drops every handle of the
    map state it was updating: accessors then see an empty map instead of
    a half-merged one."""
    world = make_world(rng)
    poses = poses_along_x(np.arange(1.0, 5.0, 1.5))
    mapper = drive(_port(CONFIG, is_online=False, seed=1), nt, world, poses,
                   device="cpu")

    class Boom(RuntimeError):
        pass

    def explode(*a, **k):
        raise Boom("injected dispatch failure")

    mapper._fused.merge = explode
    scan = sensor_scan(world, poses[-1])
    batch = mapper.apply_input_filters(
        nt.PointBatch.from_numpy(scan, device="cpu"))
    with pytest.raises(RuntimeError, match="unrecoverable"):
        mapper.process_input(batch, poses[-1], int(9e9),
                             scan_valid_hint=scan.shape[0])
    assert mapper.map.local is None
    assert mapper.map.is_local_point_cloud_empty()
    assert mapper._fused_state is None and not mapper._fused_pending
    assert mapper.icp._ref is None and mapper.icp._ref_pack is None


def _drive_long(mapper, pkg, world, xs, rng_m=15, **kw):
    for i, x in enumerate(xs):
        pose = pose_at(x)
        batch = pkg.PointBatch.from_numpy(scan_at(world, pose, rng_m), **kw)
        mapper.process_input(mapper.apply_input_filters(batch), pose,
                             i * int(1e8))


def test_online_mode_async_updates(rng):
    """``tests/test_rolling_window.py``'s online drive: 60 m of corridor
    with a 15 m sensor range; the map and trajectory are complete once the
    in-flight merge and the queued cell updates are done, and the map
    matches the JAX package's."""
    world = corridor_world(rng, length=100.0, n=2000)
    xs = np.arange(2.0, 60.0, 8.0)
    mapper = _port(small_range_config(), is_online=True)
    _drive_long(mapper, nt, world, xs, device="cpu")
    if mapper._map_update_future is not None:
        mapper._map_update_future.result()
    mapper.map.wait_for_updates()
    n = mapper.get_map()["positions"].shape[0]
    assert n > 500
    assert len(mapper.get_trajectory()) == len(xs)
    ref = nj.Mapper(small_range_config(), is_3d=True, is_online=True)
    _drive_long(ref, nj, world, xs)
    ref.drain()
    n_ref = ref.get_map()["positions"].shape[0]
    assert abs(n - n_ref) <= 0.005 * n_ref
    mapper.shutdown()
    ref.shutdown()


def test_online_stepwise_path_merges_and_loads_in_the_background(rng):
    """A bound checker sends every scan through the stepwise path: online,
    its merges run on the executor (a scan arriving while one is in flight
    does not merge) and the window's cell events go to the map's thread.
    After the last future and the queued events, every scan has a pose,
    cells were evicted behind the robot, and the global map holds the
    corridor seen so far."""
    world = corridor_world(rng, length=140.0, n=3000)
    cfg = small_range_config()
    cfg["icp"] = dict(cfg["icp"])
    cfg["icp"]["transformationCheckers"] = [
        {"CounterTransformationChecker": {"maxIterationCount": 15}},
        {"BoundTransformationChecker": {"maxRotationNorm": 0.5,
                                        "maxTranslationNorm": 0.5}}]
    xs = np.arange(2.0, 110.0, 6.0)
    mapper = _port(cfg, is_online=True)
    submitted = []
    inner = mapper._executor.submit

    def submit(*a, **k):
        submitted.append(a[0].__name__)
        return inner(*a, **k)
    mapper._executor.submit = submit
    _drive_long(mapper, nt, world, xs, device="cpu")
    assert mapper._fused_state is None  # never entered the pipelined loop
    if mapper._map_update_future is not None:
        mapper._map_update_future.result()
    mapper.map.wait_for_updates()
    assert submitted and set(submitted) == {"update_local_point_cloud"}
    assert len(mapper.get_trajectory()) == len(xs)
    assert len(mapper.map.cell_manager.get_all_cell_ids()) > 0
    pts = mapper.get_map()["positions"]
    assert pts.shape[0] > 1000
    assert pts[:, 0].min() < 10.0 and pts[:, 0].max() > 100.0
    mapper.shutdown()
    assert mapper.map._update_thread is None
