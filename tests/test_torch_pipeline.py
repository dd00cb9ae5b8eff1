"""The pipelined per-scan loop of the port's ``Mapper`` against the JAX
``Mapper``'s fused path (CPU).

Both packages run the same host loop: a provisional bound on the map count,
adaptive headroom for decimating configs, a shrink of an oversized buffer, a
re-merge of a scan that filled the buffer, and rolling-window events
deferred to the next sync point.  Each sequence below makes one of these
fire in both packages -- counted by wrapping the method on each mapper --
and compares poses, map counts and maps as ``test_torch_mapper_e2e.py``
does.  Both mappers are drained after every scan, so that each harvests a
scan at the same point of the sequence (on the CPU the port's mirrors land
at once, the reference's when its program has run).

At these sizes the reference re-merges every merged scan of a decimating
config once the buffer has fewer than 1024 free slots; the first sequence
meets that on purpose.
"""
import copy

import numpy as np
import pytest

import norlab_icp_mapper_tpu as nj
import norlab_icp_mapper_tpu_torch as nt

from test_torch_mapper_e2e import (assert_maps_close, bundled, make_world,
                                   pose_at, scan_at)


def _count_calls(mapper, name, tally):
    inner = getattr(mapper, name)

    def counted(*args, **kwargs):
        tally[name] = tally.get(name, 0) + 1
        return inner(*args, **kwargs)
    setattr(mapper, name, counted)


def _mappers(cfg):
    mj = nj.Mapper(copy.deepcopy(cfg))
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    calls_j, calls_t = {}, {}
    for name in ("_remerge_overflow", "_shrink_bufs"):
        _count_calls(mj, name, calls_j)
        _count_calls(mt, name, calls_t)
    return mj, mt, calls_j, calls_t


def _step_locked(mj, mt, world, xs, hints, noise, max_range=15.0,
                 after_scan=None):
    nrng = np.random.default_rng(1)
    for i, (x, hint) in enumerate(zip(xs, hints)):
        true = pose_at(x)
        prior = true.copy()
        if i > 0 and noise:
            prior[:3, 3] += nrng.normal(size=3).astype(np.float32) * noise
        scan = scan_at(world, true, max_range)
        for m, pkg in ((mj, nj), (mt, nt)):
            kw = {"device": "cpu"} if pkg is nt else {}
            m.process_input(
                m.apply_input_filters(pkg.PointBatch.from_numpy(scan, **kw)),
                prior, i * int(1e8),
                scan_valid_hint=hint(scan) if callable(hint) else hint)
            m.drain()
        np.testing.assert_allclose(mt.get_pose(), mj.get_pose(), atol=1e-4)
        assert mt.map.known_count() == pytest.approx(
            mj.map._known_count, rel=0.005)
        if after_scan is not None:
            after_scan()


XS = [2.0, 2.5, 3.0, 3.5, 4.0, 4.5, 5.0]


def test_adaptive_headroom_and_overflow_remerge(rng):
    """Point-to-plane with octree decimation, each scan's hint its own size:
    the buffer keeps under 1024 free slots, so every merge after the first
    counts as one that may have overflowed and is replayed through the
    stepwise path (DynamicPoints left out) at the next scan, in both
    packages; after four merges the adaptive headroom takes over."""
    cfg = bundled("config_p2plane.yaml", True)
    mj, mt, cj, ct = _mappers(cfg)
    world = make_world(rng)
    _step_locked(mj, mt, world, XS, [lambda s: s.shape[0]] * len(XS), 0.03)
    assert mt.map.growth_bounded_by_decimation()
    assert len(mt._delta_hist) >= 4 and len(mj._delta_hist) >= 4
    assert list(mt._delta_hist) == pytest.approx(list(mj._delta_hist),
                                                 abs=10)
    assert ct.get("_remerge_overflow", 0) >= 3
    assert ct.get("_remerge_overflow") == cj.get("_remerge_overflow")
    for pj, pt in zip(mj.get_trajectory().poses, mt.get_trajectory().poses):
        np.testing.assert_allclose(pt, np.asarray(pj), atol=1e-4)
    assert_maps_close(mj.get_map(), mt.get_map(), 0.005, nn_tol=2e-4)


def test_oversized_buffer_shrinks(rng):
    """A loader hint far above the scans' size sizes the first buffers for
    40,000 points; once four merges have measured the real growth, the
    adaptive headroom (about 8,192) shows the buffer at least a bucket
    oversize and both packages compact and cut it, then map on."""
    cfg = bundled("config_p2plane.yaml", True)
    mj, mt, cj, ct = _mappers(cfg)
    world = make_world(rng)
    caps = []
    _step_locked(mj, mt, world, XS, [40_000] * len(XS), 0.03,
                 after_scan=lambda: caps.append(mt.map.local.capacity))
    assert ct.get("_shrink_bufs", 0) >= 1
    assert ct.get("_shrink_bufs") == cj.get("_shrink_bufs")
    assert caps[-1] < caps[0]
    assert mt.map.local.capacity == mj.map.local.capacity
    assert mt.icp._ref.capacity == mt.map.local.capacity
    assert int(mt.icp._ref_pack.n_valid) == int(mt.icp._ref.count())
    assert_maps_close(mj.get_map(), mt.get_map(), 0.005, nn_tol=2e-4)


def _long_world(rng, n=4000, length=300.0):
    x = rng.uniform(0, length, n).astype(np.float32)
    side = rng.integers(0, 3, n)
    return np.column_stack([
        x, np.where(side == 0, -3.07, np.where(side == 1, 3.07,
                                               rng.uniform(-3, 3, n))),
        np.where(side == 2, 0.07, rng.uniform(0.07, 2, n))
    ]).astype(np.float32)


def test_window_events_are_deferred_to_the_next_sync(rng):
    """With a 15 m sensor range the window shifts every few scans.  The
    loop advances the window at dispatch and keeps its load / unload events
    until the next sync point (the next scan's start, or ``drain``): right
    after ``process_input`` the events are pending and the cells are
    untouched; after ``drain`` they are applied, and both packages hold the
    same cells, window and map."""
    world = _long_world(rng)
    cfg = bundled("config.yaml", True)
    cfg["mapper"]["sensorMaxRange"] = 15
    mj = nj.Mapper(copy.deepcopy(cfg))
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    deferred = 0
    for i, xr in enumerate(np.arange(2.0, 120.0, 10.0)):
        pose = pose_at(xr)
        scan = scan_at(world, pose, 15.0)
        mj.process_input(mj.apply_input_filters(nj.PointBatch.from_numpy(
            scan)), pose, i * int(1e8), scan_valid_hint=4096)
        ids_before = sorted(mt.map.cell_manager.get_all_cell_ids())
        mt.process_input(mt.apply_input_filters(nt.PointBatch.from_numpy(
            scan, device="cpu")), pose, i * int(1e8), scan_valid_hint=4096)
        if mt._pending_window:
            deferred += 1
            assert sorted(mt.map.cell_manager.get_all_cell_ids()) \
                == ids_before
            assert mt._pending_window == mj._pending_window
            mt.drain()
            mj.drain()
            assert not mt._pending_window
            assert sorted(mt.map.cell_manager.get_all_cell_ids()) == sorted(
                mj.map.cell_manager.get_all_cell_ids())
    mj.drain()
    mt.drain()
    assert deferred >= 2
    assert mt.map._window == mj.map._window
    assert mt.map.loaded_cell_ids == mj.map.loaded_cell_ids
    assert_maps_close(mj.get_map(), mt.get_map(), 0.005)
