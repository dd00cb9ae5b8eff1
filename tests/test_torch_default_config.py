"""Port parity, the default-config path as a whole: ``Mapper(config=None)``
in the JAX package and in the port, fed the same synthetic drive (CPU).

The default config is what a YAML without ``icp:`` / ``mapper:`` runs: a
KDTreeMatcher without ``maxDist`` (brute-force 1-NN), RandomSampling 0.75 on
the reading, SurfaceNormal ``knn: 10`` without ``maxDist`` as reference
filter (k-NN normals), trimmed 0.85, point-to-plane, a map update every
metre, and PointDistanceMapperModule at 0.15 m.

Sizes as in ``test_torch_mapper_e2e.py``: scans of at most 1024 points,
every plane well inside the 0.15 m lattice, ``scan_valid_hint=4096`` for
both mappers, the rematch period pinned.

PointDistance keeps a scan point when its nearest map point is at least
0.15 m away.  The reference's CPU search ranks by the expanded-form distance
(error about ``4 * eps * |x|^2`` ~ 2e-4 m^2 at 20 m, i.e. below 1e-3 m in
distance at the gate), the port by the exact subtract-first distance, and
the two poses differ by up to 1e-4 m: a decision may differ where a scan
point's nearest map distance lies within ``BORDER`` = 1e-3 m of 0.15 m.  The
tests count such borderline points on the host (scipy cKDTree) and bound the
symmetric difference of the two maps by that count.
"""
import copy

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import norlab_icp_mapper_tpu as nj
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch import convert
from norlab_icp_mapper_tpu_torch.ops.nn import KnnPack

from test_torch_mapper_e2e import (ReferenceDraws, feed, make_world,
                                   pose_at, scan_at)

MIN_DIST = 0.15
BORDER = 1e-3
XS = [2.0, 2.6, 3.2, 3.8, 4.4, 5.0]  # a merge every second scan


@pytest.fixture(autouse=True)
def _pin_rematch(monkeypatch):
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "3")


def _to_map_frame(scan, pose):
    d = pose.shape[0] - 1
    return scan @ pose[:d, :d].T + pose[:d, d]


def _borderline(map_before, scan, pose):
    """Scan points whose nearest map point lies within BORDER of the gate."""
    if map_before.shape[0] == 0:
        return 0
    dist, _ = cKDTree(map_before).query(_to_map_frame(scan, pose))
    return int((np.abs(dist - MIN_DIST) < BORDER).sum())


def _symmetric_difference(a, b, tol):
    """Points of either cloud without a point of the other within ``tol``."""
    da, _ = cKDTree(b).query(a)
    db, _ = cKDTree(a).query(b)
    return int((da > tol).sum() + (db > tol).sum())


def _jax_state(mj):
    """The reference mapper's state after drain(), as numpy: the local map
    and the reference-filtered copy the ICP engine matches against."""
    def arrays(batch):
        return (np.asarray(batch.positions), np.asarray(batch.mask),
                {k: np.asarray(v) for k, v in batch.descriptors.items()})
    cells = {cid: mj.map.cell_manager.retrieve_cell(cid)
             for cid in mj.map.cell_manager.get_all_cell_ids()}
    return dict(map_arrays=arrays(mj.map.local),
                ref_arrays=arrays(mj.icp._ref), pose=mj.get_pose(),
                last_pose=mj.last_pose_where_map_was_updated,
                last_time_ns=mj.last_time_map_was_updated,
                window=mj.map._window,
                loaded_cell_ids=set(mj.map.loaded_cell_ids), cells=cells)


def test_default_settings_match_reference():
    mj, mt = nj.Mapper(None), nt.Mapper(None, device="cpu")
    for attr in ("map_update_condition", "map_update_distance",
                 "map_update_overlap", "map_update_delay"):
        assert getattr(mt, attr) == getattr(mj, attr), attr
    assert [m.NAME for m in mt.map.modules] == [m.NAME for m in mj.map.modules]
    assert mt.map.modules[0].params == mj.map.modules[0].params
    assert mt.map.merge_headroom_scans() == mj.map.merge_headroom_scans() == 1
    for attr in ("match_knn", "match_max_dist", "outlier_filters",
                 "minimizer", "max_iter", "diff_checker", "bound_checker"):
        assert getattr(mt.icp, attr) == getattr(mj.icp, attr), attr
    assert mt.icp.match_max_dist == np.inf and mt.icp.match_knn == 1
    for chain in ("reading_filters", "reference_filters",
                  "reading_step_filters"):
        ft, fj = getattr(mt.icp, chain).filters, getattr(mj.icp, chain).filters
        assert [f.NAME for f in ft] == [f.NAME for f in fj]
        assert [f.params for f in ft] == [f.params for f in fj]
    assert len(mt.input_filters) == len(mt.post_filters) == 0
    # a YAML with only other sections runs the same defaults
    mt2 = nt.Mapper({"input": []}, device="cpu")
    assert mt2.icp.match_max_dist == np.inf
    assert mt2.map.modules[0].NAME == "PointDistanceMapperModule"


def test_default_config_step_locked(rng):
    """Every scan starts from the SAME state in both packages: the
    reference's, carried over by ``convert.mapper_state_from_numpy`` with
    its ``ref`` buffer (the map with k-NN normals, which differs from the
    map buffer in this config).  Poses within 1e-4 (both solvers walk the
    same iterations in f32); after each scan the maps differ by no more
    points than were borderline in that scan's merge."""
    world = make_world(rng)
    mj = nj.Mapper(None)
    draws = ReferenceDraws()
    mt = nt.Mapper(None, device="cpu", draw_source=draws)
    nrng = np.random.default_rng(1)
    merges, iters = 0, []
    for i, x in enumerate(XS):
        true = pose_at(x)
        prior = true.copy()
        if i > 0:
            prior[:3, 3] += nrng.normal(size=3).astype(np.float32) * 0.05
        scan = scan_at(world, true)
        if i > 0:
            convert.mapper_state_from_numpy(mt, **_jax_state(mj))
            assert isinstance(mt.icp._ref_pack, KnnPack)
            assert "normals" in mt.icp._ref.descriptors
            assert "normals" not in mt.map.local.descriptors
        before = mt.get_map()["positions"]
        feed(mj, nj.PointBatch, scan, prior, i * int(1e8))
        mj.drain()
        draws.next_scan()
        feed(mt, nt.PointBatch, scan, prior, i * int(1e8), device="cpu")
        iters.append(mt.last_iterations)
        np.testing.assert_allclose(mt.get_pose(), mj.get_pose(), atol=1e-4)
        if i > 0:
            # the prior was off by ~5 cm; ICP brings it back
            assert np.linalg.norm(mt.get_pose()[:3, 3] - true[:3, 3]) < 0.03
        ga, gb = mj.get_map()["positions"], mt.get_map()["positions"]
        grew = gb.shape[0] > before.shape[0]
        merges += grew
        border = _borderline(before, scan, mt.get_pose()) if grew else 0
        assert _symmetric_difference(ga, gb, 2e-4) <= border, (i, border)
        assert abs(ga.shape[0] - gb.shape[0]) <= border
    assert merges == 3 and min(iters[1:]) > 1
    assert float(mt.overlap) == 1.0  # no radius: every reading point matches


@pytest.mark.parametrize("is_3d", [True, False])
def test_default_config_free_running(rng, is_3d):
    """Each package carries its own state over six scans, the port fed the
    reference's draws.  Poses within 1e-4.  A borderline decision in one
    merge stays in the map, and the point it added or left out can decide
    the scan points of later merges that fall within 0.15 m of it (a
    handful on these sparse scans): the symmetric difference of the final
    maps is bounded by 8 points per borderline decision, and is 0 when
    there was none."""
    dim = 3 if is_3d else 2
    if is_3d:
        world = make_world(rng)
    else:
        n = 160
        u = lambda lo, hi: rng.uniform(lo, hi, size=n).astype(np.float32)
        c = lambda v: np.full(n, v, np.float32)
        world = np.concatenate([np.column_stack(w) for w in [
            (u(0, 30), c(-3.07)), (u(0, 30), c(3.07)), (c(0.07), u(-3, 3)),
            (c(30.07), u(-3, 3)), (c(9.07), u(-1, 1))]])
    mj = nj.Mapper(None, is_3d=is_3d)
    draws = ReferenceDraws()
    mt = nt.Mapper(None, is_3d=is_3d, device="cpu", draw_source=draws)
    nrng = np.random.default_rng(1)
    border = 0
    for i, x in enumerate(XS):
        true = pose_at(x, dim=dim)
        prior = true.copy()
        if i > 0:
            prior[:dim, dim] += nrng.normal(size=dim).astype(np.float32) * 0.03
        scan = scan_at(world, true)
        before = mt.get_map()["positions"]
        feed(mj, nj.PointBatch, scan, prior, i * int(1e8))
        draws.next_scan()
        feed(mt, nt.PointBatch, scan, prior, i * int(1e8), device="cpu")
        if i > 0 and mt.map.known_count() > before.shape[0]:
            border += _borderline(before, scan, mt.get_pose())
    mj.drain()
    for pj, pt in zip(mj.get_trajectory().poses, mt.get_trajectory().poses):
        np.testing.assert_allclose(pt, pj, atol=1e-4)
    ga, gb = mj.get_map(), mt.get_map()
    assert sorted(ga) == sorted(gb) == ["positions"]
    assert gb["positions"].shape[1] == dim
    diff = _symmetric_difference(ga["positions"], gb["positions"], 2e-4)
    assert diff <= 8 * border, (diff, border)
    # the map only grows under this config, and no scan point was merged
    # closer than the gate to the map it met
    assert gb["positions"].shape[0] > scan_at(world, pose_at(XS[0], dim=dim)
                                              ).shape[0]


def test_default_config_with_own_draws(rng):
    """The port drawing from its own seeded generator: another random three
    quarters of each reading.  Registration of a sparse scan is good to
    about a centimetre on this world, so two samplings agree to about that:
    poses within 2.5e-2 of the reference's and 3e-2 of the truth, map
    counts within 5 %."""
    world = make_world(rng)
    mj, mt = nj.Mapper(None), nt.Mapper(None, device="cpu", seed=3)
    nrng = np.random.default_rng(1)
    for i, x in enumerate(XS):
        true = pose_at(x)
        prior = true.copy()
        if i > 0:
            prior[:3, 3] += nrng.normal(size=3).astype(np.float32) * 0.03
        scan = scan_at(world, true)
        feed(mj, nj.PointBatch, scan, prior, i * int(1e8))
        feed(mt, nt.PointBatch, scan, prior, i * int(1e8), device="cpu")
        assert np.abs(mt.get_pose()[:3, 3] - true[:3, 3]).max() < 3e-2
    mj.drain()
    for pj, pt in zip(mj.get_trajectory().poses, mt.get_trajectory().poses):
        np.testing.assert_allclose(pt, pj, atol=2.5e-2)
    na = mj.get_map()["positions"].shape[0]
    nb = mt.get_map()["positions"].shape[0]
    assert abs(na - nb) <= 0.05 * max(na, nb)


def test_bootstrap_runs_the_reference_filter_and_the_map_only_grows(rng):
    """The first scan goes into the map whole and the engine's reference
    gets k-NN normals over it; with no decimating module the map only
    grows, the buffer grows with it (one scan of headroom), and growing the
    buffer pads the reference without running its filter again."""
    world = make_world(rng, 3000)
    mt = nt.Mapper(None, device="cpu")
    counts, caps = [], []
    for i, x in enumerate(np.arange(2.0, 9.0, 1.1)):
        scan = scan_at(world, pose_at(x), max_range=6.0)
        hint = scan.shape[0]
        if i == 3:
            ref_before = mt.icp._ref
        mt.process_input(
            mt.apply_input_filters(nt.PointBatch.from_numpy(scan,
                                                            device="cpu")),
            pose_at(x), i * int(1e8), scan_valid_hint=hint)
        if i == 0:
            assert mt.map.known_count() == hint  # the scan went in whole
            nrm = mt.icp._ref.descriptors["normals"]
            valid = mt.icp._ref.mask
            np.testing.assert_allclose(
                torch.linalg.norm(nrm[valid], dim=1).numpy(), 1.0, atol=1e-4)
            assert "normals" not in mt.map.local.descriptors
        counts.append(mt.map.known_count())
        caps.append(mt.map.local.capacity)
        assert mt.icp._ref.capacity == mt.map.local.capacity
        assert int(mt.icp._ref.count()) == counts[-1]
        assert int(mt.icp._ref_pack.n_valid) == counts[-1]
    assert all(b >= a for a, b in zip(counts, counts[1:]))
    assert counts[-1] > 2 * counts[0]
    assert caps[-1] > caps[0]
    assert all(c >= n for c, n in zip(caps, counts))
    # a merged scan point is at least the gate away from the map it met
    pts = mt.get_map()["positions"]
    first = scan_at(world, pose_at(2.0), max_range=6.0).shape[0]
    d, _ = cKDTree(pts[:first]).query(pts[first:])
    assert (d >= MIN_DIST - 1e-3).all()


def test_growing_the_buffer_keeps_the_reference(rng):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    mt = nt.Mapper(None, device="cpu")
    mt.map.set_local(nt.PointBatch.from_numpy(pts, device="cpu"), 300)
    ref = mt.icp._ref
    mt.map.grow_local(1024)
    assert mt.map.local.capacity == mt.icp._ref.capacity == 1024
    np.testing.assert_array_equal(
        mt.icp._ref.descriptors["normals"][:ref.capacity].numpy(),
        ref.descriptors["normals"].numpy())
    assert not bool(mt.icp._ref.mask[ref.capacity:].any())
    assert int(mt.icp._ref_pack.n_valid) == 300
    assert mt.icp._ref_pack.ref_c.shape[0] == 1024


def test_convert_carries_the_ref_buffer_bit_for_bit(rng):
    world = make_world(rng)
    mj = nj.Mapper(None)
    feed(mj, nj.PointBatch, scan_at(world, pose_at(2.0)), pose_at(2.0), 0)
    feed(mj, nj.PointBatch, scan_at(world, pose_at(2.6)), pose_at(2.6),
         int(1e8))
    mj.drain()
    state = _jax_state(mj)
    mt = nt.Mapper(None, device="cpu")
    convert.mapper_state_from_numpy(mt, **state)
    pos, mask, desc = state["ref_arrays"]
    np.testing.assert_array_equal(mt.icp._ref.positions.numpy(), pos)
    np.testing.assert_array_equal(mt.icp._ref.mask.numpy(), mask)
    np.testing.assert_array_equal(mt.icp._ref.descriptors["normals"].numpy(),
                                  desc["normals"])
    assert sorted(mt.icp._ref.descriptors) == sorted(desc)
    pack = mt.icp._ref_pack
    assert isinstance(pack, KnnPack) and int(pack.n_valid) == int(mask.sum())
    np.testing.assert_array_equal(pack.ref_c[:int(pack.n_valid)].numpy(),
                                  pos[mask])
    # the per-scan step picks the carried buffers up as they are
    bufs, _ = mt._fused.init_state(mt.map.local, mt.icp._ref, mt.pose,
                                   mt.last_pose_where_map_was_updated, 0.0)
    assert bufs["ref"] is mt.icp._ref and bufs["ref_pack"] is pack
    assert bufs["ref"] is not bufs["map"]
    # without ref arrays the port recomputes the reference itself: the same
    # normals up to sign and near-tie neighbour choices
    mt2 = nt.Mapper(None, device="cpu")
    convert.mapper_state_from_numpy(mt2, **{**state, "ref_arrays": None})
    cos = np.abs(np.sum(mt2.icp._ref.descriptors["normals"].numpy()[mask]
                        * desc["normals"][mask], axis=1))
    assert (cos > 1 - 1e-4).mean() > 0.99


def test_bound_checker_config_takes_the_stepwise_path_and_throws(rng):
    """A config with a BoundTransformationChecker never enters the per-scan
    step (it cannot throw mid-pipeline): both packages register through the
    engine's call, give the same poses, and raise when a prior is further
    off than the bound."""
    world = make_world(rng)
    cfg = {"icp": {
        "matcher": {"KDTreeMatcher": {"knn": 1}},
        "referenceDataPointsFilters": [
            {"SurfaceNormalDataPointsFilter": {"knn": 10}}],
        "outlierFilters": [{"TrimmedDistOutlierFilter": {"ratio": 0.85}}],
        "errorMinimizer": "PointToPlaneErrorMinimizer",
        "transformationCheckers": [
            {"CounterTransformationChecker": {"maxIterationCount": 40}},
            {"DifferentialTransformationChecker": {
                "minDiffRotErr": 0.001, "minDiffTransErr": 0.001,
                "smoothLength": 4}},
            {"BoundTransformationChecker": {"maxRotationNorm": 0.2,
                                            "maxTranslationNorm": 0.2}}]}}
    mj = nj.Mapper(copy.deepcopy(cfg))
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    nrng = np.random.default_rng(1)
    for i, x in enumerate(XS[:4]):
        true = pose_at(x)
        prior = true.copy()
        if i > 0:
            prior[:3, 3] += nrng.normal(size=3).astype(np.float32) * 0.03
        scan = scan_at(world, true)
        feed(mj, nj.PointBatch, scan, prior, i * int(1e8))
        feed(mt, nt.PointBatch, scan, prior, i * int(1e8), device="cpu")
        assert mt._fused_state is None  # the per-scan step never ran
        np.testing.assert_allclose(mt.get_pose(), mj.get_pose(), atol=1e-4)
    far = pose_at(XS[4])
    far[:3, 3] += np.float32([0.5, 0.3, 0.0])
    scan = scan_at(world, pose_at(XS[4]))
    with pytest.raises(RuntimeError, match="BoundTransformationChecker"):
        feed(mj, nj.PointBatch, scan, far, int(4e8))
    with pytest.raises(RuntimeError, match="BoundTransformationChecker"):
        feed(mt, nt.PointBatch, scan, far, int(4e8), device="cpu")
    assert len(mt.get_trajectory()) == 4  # the aborted scan left no pose
