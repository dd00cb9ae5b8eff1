"""Port parity: ``utils/`` (tracing, overflow records, checkpoints, metrics)
and the ICP engine's inspectors, against the JAX package (CPU).

Tolerances: the inspected registrations run the same iterations in both
packages (the port's sweep matcher against the reference's grid hash, exact
where nothing overflows): per-iteration overlap within 1e-5 and residual
within 1e-5 m, corrections within 1e-4.  Checkpoints are compared bit for
bit; metrics (numpy in both) within 1e-12.
"""
import copy
import os

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import norlab_icp_mapper_tpu as nj
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu.utils import checkpoint as jck, metrics as jm
from norlab_icp_mapper_tpu_torch.utils import (checkpoint as tck,
                                               metrics as tm, tracing)

from test_inspector_and_caps import engine_config, structured_cloud
from test_torch_mapper_e2e import bundled, feed, make_world, pose_at, scan_at


@pytest.mark.parametrize("inspector", ["PerformanceInspector", "VTK"])
def test_inspector_history_matches_jax(rng, tmp_path, inspector):
    cloud = structured_cloud(rng)
    moved = cloud + np.array([0.08, -0.05, 0.03], np.float32)
    if inspector == "VTK":
        insp = {"VTKFileInspector": {"baseFileName": str(tmp_path / "t")}}
        insp_j = {"VTKFileInspector": {"baseFileName": str(tmp_path / "j")}}
    else:
        insp = insp_j = inspector
    ej = nj.ICPEngine(engine_config(insp_j), dim=3)
    ej.set_map(nj.PointBatch.from_numpy(cloud))
    rj = ej(nj.PointBatch.from_numpy(moved))
    et = nt.ICPEngine(engine_config(insp), dim=3)
    et.set_map(nt.PointBatch.from_numpy(cloud, device="cpu"))
    rt = et(nt.PointBatch.from_numpy(moved, device="cpu"))
    hj, ht = ej.inspector.history, et.inspector.history
    assert rt.iterations == int(rj.iterations) == len(ht) == len(hj) >= 2
    for a, b in zip(ht, hj):
        assert a["iteration"] == b["iteration"]
        assert a["overlap"] == pytest.approx(b["overlap"], abs=1e-5)
        assert a["residual"] == pytest.approx(b["residual"], abs=1e-5)
    np.testing.assert_allclose(rt.correction.numpy(),
                               np.asarray(rj.correction), atol=1e-4)
    if inspector == "VTK":
        files = sorted(os.listdir(tmp_path / "t"))
        assert files == sorted(os.listdir(tmp_path / "j"))
        assert len(files) == rt.iterations
        from norlab_icp_mapper_tpu.io.vtk import read_vtk as jread
        from norlab_icp_mapper_tpu_torch.io.vtk import read_vtk
        pt, _ = read_vtk(str(tmp_path / "t" / files[-1]))
        pj, _ = jread(str(tmp_path / "j" / files[-1]))
        np.testing.assert_allclose(pt, pj, atol=1e-4)


def test_mapper_routes_inspector_configs_to_the_stepwise_path(rng,
                                                              monkeypatch):
    """An inspector records every iteration: the Mapper registers such a
    config on its stepwise path, as the JAX package does."""
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "3")
    world = make_world(rng)
    cfg = bundled("config_p2plane.yaml", True)
    cfg["icp"]["inspector"] = "PerformanceInspector"
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    for i, x in enumerate([2.0, 2.5, 3.0]):
        feed(mt, nt.PointBatch, scan_at(world, pose_at(x)), pose_at(x),
             i * int(1e8), device="cpu")
    assert mt._fused_state is None and not mt._fused_pending
    assert len(mt.icp.inspector.history) >= 2


def test_overflow_totals_sum_the_wrappers_outputs(rng, monkeypatch):
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "3")
    tracing.set_overflow_sink(tracing.accumulate_overflow)
    try:
        base = tracing.overflow_totals()
        dst = nt.PointBatch.from_numpy(
            rng.normal(size=(100, 3)).astype(np.float32), capacity=128,
            device="cpu")
        src = nt.PointBatch.from_numpy(
            rng.normal(size=(100, 3)).astype(np.float32), device="cpu")
        out, dropped = nt.points.insert(dst, src, return_dropped=True)
        assert int(out.count()) == 128 and int(dropped) == 72
        # a mapper's sweeps report theirs: the totals are the sum of what
        # the wrappers returned (the last_overflow of each pass)
        world = make_world(rng)
        mt = nt.Mapper(copy.deepcopy(bundled("config_p2plane.yaml", True)),
                       device="cpu")
        sums = {"icp_matcher_sweep": 0, "dynamic_points_sweep": 0,
                "surface_normal_sweep": 0}
        for i, x in enumerate([2.0, 2.5, 3.0]):
            feed(mt, nt.PointBatch, scan_at(world, pose_at(x)), pose_at(x),
                 i * int(1e8), device="cpu")
            if i > 0:
                sums["icp_matcher_sweep"] += int(mt.icp.last_overflow)
                sums["dynamic_points_sweep"] += int(
                    mt.map.modules[0].last_overflow)
            sums["surface_normal_sweep"] += int(
                mt.post_filters.filters[0].last_overflow)
        tot = tracing.overflow_totals()
        delta = {k: v - base.get(k, 0) for k, v in tot.items()}
        assert delta["points_insert"] == 72
        for k, v in sums.items():
            assert delta[k] == v, (k, delta, sums)
        # a count on a tensor stays a tensor until read
        assert isinstance(tracing._overflow_totals["points_insert"],
                          torch.Tensor)
    finally:
        tracing.set_overflow_sink(None)
    before = tracing.overflow_totals()
    nt.points.insert(dst, src)  # no sink: nothing is recorded
    assert tracing.overflow_totals() == before


def test_stage_timer_and_trace():
    t = tracing.StageTimer(sync=False)
    for _ in range(2):
        with t.stage("a"):
            with tracing.trace("inner"):
                torch.ones(3).sum()
    s = t.summary()
    assert s["a"]["count"] == 2 and s["a"]["total_ms"] >= 0
    assert "a" in t.report()
    # sync=True on a machine without a card times on the host clock alone
    ts = tracing.StageTimer(sync=True)
    with ts.stage("b"):
        pass
    assert ts.summary()["b"]["count"] == 1


def _drive(mapper, batch_cls, world, xs, **kw):
    for i, x in enumerate(xs):
        feed(mapper, batch_cls, scan_at(world, pose_at(x)), pose_at(x),
             i * int(1e8), **kw)


def _assert_same_checkpoint(pa, pb):
    with np.load(pa) as a, np.load(pb) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_checkpoint_round_trip_and_across_packages(rng, tmp_path,
                                                   monkeypatch):
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "3")
    world = make_world(rng)
    cfg = bundled("config_p2plane.yaml", True)
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    _drive(mt, nt.PointBatch, world, [2.0, 2.5, 3.0], device="cpu")
    pt = str(tmp_path / "port.npz")
    tck.save_checkpoint(pt, mt)

    # round trip: a fresh port mapper resumes localization-only
    m2 = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    tck.load_checkpoint(pt, m2, localization_only=True)
    assert not m2.get_is_mapping()
    assert len(m2.get_trajectory()) == 3
    np.testing.assert_array_equal(m2.get_pose(), mt.get_pose())
    p2 = str(tmp_path / "port2.npz")
    tck.save_checkpoint(p2, m2)
    _assert_same_checkpoint(pt, p2)
    n_map = m2.get_map()["positions"].shape[0]
    feed(m2, nt.PointBatch, scan_at(world, pose_at(3.2)), pose_at(3.2),
         4 * int(1e8), device="cpu")
    assert np.linalg.norm(m2.get_pose()[:3, 3] - pose_at(3.2)[:3, 3]) < 0.02
    assert m2.get_map()["positions"].shape[0] == n_map

    # the port's checkpoint into the JAX mapper and back
    mj = nj.Mapper(copy.deepcopy(cfg))
    jck.load_checkpoint(pt, mj, localization_only=True)
    pj = str(tmp_path / "jax.npz")
    jck.save_checkpoint(pj, mj)
    _assert_same_checkpoint(pt, pj)
    m3 = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    tck.load_checkpoint(pj, m3)
    assert m3.get_is_mapping()
    p3 = str(tmp_path / "port3.npz")
    tck.save_checkpoint(p3, m3)
    _assert_same_checkpoint(pt, p3)


def test_metrics_match_jax(rng):
    est = rng.normal(size=(20, 3))
    ref = est @ nj.se3.exp_se3(jnp.asarray(
        [0.1, 0, 0, 0, 0, 0.3], jnp.float32))[:3, :3].__array__().T + 0.2
    ref = ref + rng.normal(scale=0.01, size=ref.shape)
    np.testing.assert_allclose(tm.align_umeyama(est, ref),
                               jm.align_umeyama(est, ref), atol=1e-12)
    for align in (False, True):
        assert tm.ate(est, ref, align) == pytest.approx(
            jm.ate(est, ref, align), abs=1e-12)
    poses = [np.asarray(nj.se3.exp_se3(jnp.asarray(
        rng.normal(size=6).astype(np.float32)))) for _ in range(8)]
    other = [p @ np.asarray(nj.se3.exp_se3(jnp.asarray(
        rng.normal(scale=0.01, size=6).astype(np.float32)))) for p in poses]
    for step in (1, 3):
        np.testing.assert_allclose(tm.rpe(other, poses, step),
                                   jm.rpe(other, poses, step), atol=1e-12)
    with pytest.raises(ValueError, match="shapes"):
        tm.ate(est, ref[:5])
