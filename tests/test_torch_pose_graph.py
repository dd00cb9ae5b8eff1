"""Port parity: keyframes and the pose graph (``slam/pose_graph.py``,
``Mapper.enable_keyframes`` / ``refine_trajectory``) against the JAX
package on the same numpy inputs (CPU).

Tolerances:

* the dense Gauss-Newton solve runs the same float32 arithmetic in both
  packages (forward-mode Jacobians of the same residual): poses within
  5e-5, costs within 1e-4 relative;
* normals: the same closed-form eigensolve on moments that the port sums
  per query and the reference as raw moments, compared up to sign (|cos| >
  1 - 1e-4 where the smallest eigenvalue is separated);
* registrations: the port's brute-force search ranks by exact
  subtract-first distances, the reference by ``|p|^2 + |r|^2 - 2 p.r``, so
  a near-tie may pick another neighbour: transforms within 1e-3 (m and
  rotation entries), overlap within 1e-3, rms within 1e-4 m.
"""
import copy
import warnings

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import norlab_icp_mapper_tpu as nj
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu.slam import pose_graph as jpg
from norlab_icp_mapper_tpu_torch import convert
from norlab_icp_mapper_tpu_torch.slam import pose_graph as tpg

from test_icp import make_structured_cloud
from test_pose_graph import circle_poses
from test_pose_graph_batched import room_world, loop_poses
from test_torch_mapper_e2e import bundled, feed, make_world, pose_at


def _noisy_loop(gt, sigma, rng):
    """Odometry edges of ``gt`` with noise, the drifted trajectory they
    integrate to, and a loop closure from the last node to the first."""
    ei, ej, Z = jpg.sequential_edges(gt)
    dim = gt.shape[-1] - 1
    Zn, drifted = [], [gt[0]]
    for k in range(len(ei)):
        xi = rng.normal(size=sigma.shape[0]).astype(np.float32) * sigma
        ex = nj.se3.exp_se3 if dim == 3 else nj.se3.exp_se2
        Zn.append(np.asarray(ex(jnp.asarray(xi))) @ Z[k])
        drifted.append(drifted[-1] @ Zn[-1])
    n = gt.shape[0]
    lc = (np.linalg.inv(gt[n - 1]) @ gt[0]).astype(np.float32)
    return (np.stack(drifted).astype(np.float32), ei + [n - 1], ej + [0],
            np.concatenate([np.stack(Zn), lc[None]]).astype(np.float32),
            [1.0] * len(Zn) + [50.0])


def _circle_2d(n, radius=5.0):
    out = []
    for th in 2 * np.pi * np.arange(n) / n:
        c, s = np.cos(th + np.pi / 2), np.sin(th + np.pi / 2)
        out.append(np.array([[c, -s, radius * np.cos(th)],
                             [s, c, radius * np.sin(th)],
                             [0, 0, 1]], np.float32))
    return np.stack(out)


@pytest.mark.parametrize("dim", [3, 2])
def test_optimize_pose_graph_matches_jax(dim):
    rng = np.random.default_rng(0)
    if dim == 3:
        gt = circle_poses(10)
        sigma = np.array([0.02, 0.02, 0, 0, 0, 0.01], np.float32)
    else:
        gt = _circle_2d(10)
        sigma = np.array([0.02, 0.02, 0.01], np.float32)
    drifted, ei, ej, Z, w = _noisy_loop(gt, sigma, rng)
    oj, cj = jpg.optimize_pose_graph(drifted, ei, ej, Z, w, iters=5)
    ot, ct = tpg.optimize_pose_graph(drifted, ei, ej, Z, w, iters=5,
                                     device="cpu")
    np.testing.assert_allclose(ot, np.asarray(oj), atol=5e-5)
    np.testing.assert_allclose(ct, np.asarray(cj), rtol=1e-4, atol=1e-7)
    assert ct[-1] < ct[0] * 0.5
    # the closure holds after the solve
    rel = np.linalg.inv(ot[-1]) @ ot[0]
    target = np.linalg.inv(gt[-1]) @ gt[0]
    assert np.linalg.norm(rel[:dim, dim] - target[:dim, dim]) < 0.05


def test_keyframe_insert_thinning_matches_jax():
    cfg_j = {"min_distance": 1.0, "max_keyframes": 4}
    cfg_t = dict(cfg_j)
    kj, kt = [], []
    stored_j, stored_t = [], []
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        for i, x in enumerate([0.0, 0.5, 1.2, 2.5, 3.0, 4.1, 5.5, 7.0, 9.5,
                               11.0, 14.0]):
            pose = pose_at(x)
            stored_j.append(jpg.keyframe_insert(kj, cfg_j, i, i, pose, 3))
            stored_t.append(tpg.keyframe_insert(kt, cfg_t, i, i, pose, 3))
    assert stored_t == stored_j
    assert [k[0] for k in kt] == [k[0] for k in kj]
    assert cfg_t == cfg_j
    assert cfg_t["thinning_events"] >= 2 and len(kt) <= 4
    thin = [w for w in caught if "max_keyframes" in str(w.message)]
    assert len(thin) == 2 * cfg_t["thinning_events"]  # both packages warn


def _keyframe_cloud(rng, n=2000):
    """Two walls and a floor (normals well defined) plus isolated points
    far away (fewer than min_knn neighbours: the zero rule)."""
    cloud = make_structured_cloud(rng, n - 20)
    lone = rng.uniform(30, 60, size=(20, 3)).astype(np.float32)
    return np.concatenate([cloud, lone]).astype(np.float32)


def test_keyframe_normals_up_to_sign_with_zero_rule(rng, monkeypatch):
    K, cap = 2, 2048
    pos = np.zeros((K, cap, 3), np.float32)
    msk = np.zeros((K, cap), bool)
    for k in range(K):
        c = _keyframe_cloud(rng)
        pos[k, :c.shape[0]] = c + 10.0 * k
        msk[k, :c.shape[0]] = True
    nj_ = np.asarray(jpg.keyframe_normals(jnp.asarray(pos), jnp.asarray(msk),
                                          radius=0.3))
    # a first window of 512 overflows on these clouds: the retry doubles it
    # until nothing overflows, and the result is the uncapped one
    monkeypatch.setattr(tpg, "_first_window", lambda radius: 512)
    nt_, ov, Ws = tpg.keyframe_normals(torch.from_numpy(pos),
                                       torch.from_numpy(msk), radius=0.3,
                                       return_overflow=True)
    nt_ = nt_.numpy()
    assert (ov == 0).all() and min(Ws) > 512
    monkeypatch.setattr(tpg, "_first_window", lambda radius: cap)
    full = tpg.keyframe_normals(torch.from_numpy(pos), torch.from_numpy(msk),
                                radius=0.3).numpy()
    np.testing.assert_array_equal(nt_, full)
    zero_j = np.all(nj_ == 0, axis=-1)
    zero_t = np.all(nt_ == 0, axis=-1)
    np.testing.assert_array_equal(zero_t, zero_j)
    assert zero_t[:, 2000:2048].all() and zero_t[msk].sum() >= K * 20
    both = ~zero_t
    cos = np.abs(np.sum(nt_ * nj_, axis=-1))[both]
    assert (cos > 1 - 1e-4).mean() > 0.995


def _structured_keyframes(rng, n=12, gap_pose=100.0):
    cloud = make_structured_cloud(rng)
    poses = np.stack([np.eye(4, dtype=np.float32)] * n)
    for i in range(1, n - 1):
        poses[i][0, 3] = gap_pose + i
    scans = [cloud if i in (0, n - 1) else cloud + 500.0 for i in range(n)]
    return np.stack(scans).astype(np.float32), poses


def test_register_and_detect_batched_match_jax(rng):
    kf, poses = _structured_keyframes(rng)
    msk = np.ones(kf.shape[:2], bool)
    kw = dict(min_index_gap=5, max_dist=2.0, match_max_dist=1.0,
              normal_radius=1.5, iters=5)
    ej = jpg.detect_loop_closures_batched(jnp.asarray(kf), jnp.asarray(msk),
                                          poses, **kw)
    et = tpg.detect_loop_closures_batched(torch.from_numpy(kf),
                                          torch.from_numpy(msk), poses, **kw)
    assert list(zip(et[0], et[1])) == list(zip(ej[0], ej[1]))
    assert (0, 11) in list(zip(et[0], et[1]))
    np.testing.assert_allclose(et[2], ej[2], atol=1e-3)
    np.testing.assert_allclose(et[3], ej[3], atol=1e-3)

    # one pair directly, from a perturbed start: T, overlap and rms
    rel0 = np.linalg.inv(
        nj.se3.exp_se3(jnp.asarray([0.05, -0.04, 0.02, 0.01, -0.02, 0.03],
                                   jnp.float32))).astype(np.float32)[None]
    nrm = np.array(jpg.keyframe_normals(jnp.asarray(kf[:1]),
                                          jnp.asarray(msk[:1]), radius=1.5))
    args = (kf[11:12], msk[11:12], kf[:1], nrm, msk[:1])
    Tj, oj, rj = jpg.register_pairs_batched(
        *[jnp.asarray(a) for a in args], rel0, max_dist=1.0, iters=5)
    Tt, ot, rt = tpg.register_pairs_batched(
        *[torch.from_numpy(a) for a in args], rel0, max_dist=1.0, iters=5)
    np.testing.assert_allclose(Tt.numpy(), np.asarray(Tj), atol=1e-3)
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=1e-3)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), atol=1e-4)
    np.testing.assert_allclose(Tt.numpy()[0], np.eye(4), atol=2e-2)
    # the plain search gives the same registration on the CPU
    Tp, op_, rp = tpg.register_pairs_batched_plain(
        *[torch.from_numpy(a) for a in args], rel0, max_dist=1.0, iters=5)
    assert torch.equal(Tp, Tt) and torch.equal(op_, ot)


def test_detect_loop_closures_serial_matches_batched(rng):
    kf, poses = _structured_keyframes(rng)
    engine = nt.ICPEngine({
        "matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 1.0}},
        "errorMinimizer": "PointToPlaneErrorMinimizer",
        "referenceDataPointsFilters": [
            {"SurfaceNormalDataPointsFilter": {"knn": 8}}],
        "transformationCheckers": [
            {"CounterTransformationChecker": {"maxIterationCount": 5}}],
    }, dim=3)
    sei, sej, sZ, _ = tpg.detect_loop_closures(list(kf), poses, engine,
                                               min_index_gap=5, max_dist=2.0,
                                               device="cpu")
    assert (0, 11) in list(zip(sei, sej))
    k = list(zip(sei, sej)).index((0, 11))
    np.testing.assert_allclose(sZ[k], np.eye(4), atol=3e-2)


REFINE_CONFIG = {
    "mapper": {"updateCondition": {"type": "delay", "value": 0.05},
               "sensorMaxRange": 50,
               "mapperModule": [{"PointDistanceMapperModule":
                                 {"minDistNewPoint": 0.1}}]},
    "icp": {"matcher": {"KDTreeMatcher": {"knn": 1, "maxDist": 1.0}},
            "errorMinimizer": "IdentityErrorMinimizer",
            "transformationCheckers": [
                {"CounterTransformationChecker": {"maxIterationCount": 1}}]},
}


def test_refine_trajectory_from_converted_keyframes(rng):
    """The JAX mapper's keyframe store (scans taken at the true poses, poses
    from drifted odometry), carried into the port by
    ``convert.keyframes_from_numpy``; ``refine_trajectory`` in both: the
    same closures, refined poses within 2e-3 m, and less error than the
    drift."""
    world = room_world(rng)
    gt = loop_poses(10)
    drifted = [gt[0]]
    for i in range(1, len(gt)):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        xi = np.array([0.04, 0.04, 0.0, 0.0, 0.0, 0.015], np.float32)
        noise = np.asarray(nj.se3.exp_se3(jnp.asarray(
            rng.normal(size=6).astype(np.float32) * xi)), np.float32)
        drifted.append((drifted[-1] @ rel @ noise).astype(np.float32))
    mj = nj.Mapper(copy.deepcopy(REFINE_CONFIG))
    mj.enable_keyframes(min_distance=0.5)
    cap = 2048
    for T_true, T_est in zip(gt, drifted):
        d = np.linalg.norm(world - T_true[:3, 3], axis=1)
        local = ((world[d < 12.0] - T_true[:3, 3]) @ T_true[:3, :3])[:cap]
        pos = np.zeros((cap, 3), np.float32)
        pos[:local.shape[0]] = local
        msk = np.arange(cap) < local.shape[0]
        mj._keyframes.append((jnp.asarray(pos), jnp.asarray(msk), T_est))
    # candidates: the pairs across the loop's start (within 9 m)
    kw = dict(min_index_gap=4, max_dist=9.0, min_overlap=0.3,
              match_max_dist=1.5, normal_radius=1.0, icp_iters=5,
              gn_iters=5)
    bj, aj, ij = mj.refine_trajectory(**kw)

    mt = nt.Mapper(copy.deepcopy(REFINE_CONFIG), device="cpu")
    kf = mj.get_keyframes()
    convert.keyframes_from_numpy(mt, np.asarray(kf[0]), np.asarray(kf[1]),
                                 kf[2], cfg=mj._kf_cfg)
    bt, at, it = mt.refine_trajectory(**kw)
    np.testing.assert_array_equal(bt, bj)
    assert it["loop_closures"] == ij["loop_closures"]
    assert it["loop_closures"] and it["n_edges"] == ij["n_edges"]
    np.testing.assert_allclose(at, aj, atol=2e-3)
    gt_xyz = np.stack([p[:3, 3] for p in gt])
    err_before = np.linalg.norm(bt[:, :3, 3] - gt_xyz, axis=1).mean()
    err_after = np.linalg.norm(at[:, :3, 3] - gt_xyz, axis=1).mean()
    assert err_after < err_before * 0.8, (err_before, err_after)


def test_mapper_keyframe_capture_matches_jax(rng, monkeypatch):
    """Keyframes captured by both Mappers on the same drive: the bootstrap
    scan on the stepwise path, the rest at harvest of the pipelined loop
    (JAX: of its fused program)."""
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "3")
    world = make_world(rng)
    cfg = bundled("config.yaml", True)
    mj = nj.Mapper(copy.deepcopy(cfg))
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu")
    for m in (mj, mt):
        m.enable_keyframes(min_distance=0.9, max_keyframes=2)
    from test_torch_mapper_e2e import scan_at
    with pytest.warns(UserWarning, match="max_keyframes"):
        for i, x in enumerate([2.0, 2.5, 3.0, 3.5, 4.0, 4.5]):
            scan = scan_at(world, pose_at(x))
            feed(mj, nj.PointBatch, scan, pose_at(x), i * int(1e8))
            feed(mt, nt.PointBatch, scan, pose_at(x), i * int(1e8),
                 device="cpu")
        mj.drain()
        mt.drain()
    kj, kt = mj.get_keyframes(), mt.get_keyframes()
    assert mt.keyframe_thinning_events == mj.keyframe_thinning_events >= 1
    np.testing.assert_allclose(kt[2], kj[2], atol=1e-5)
    np.testing.assert_array_equal(kt[1].numpy(), np.asarray(kj[1]))
    m = kt[1].numpy()
    np.testing.assert_allclose(kt[0].numpy()[m], np.asarray(kj[0])[m],
                               atol=1e-5)
