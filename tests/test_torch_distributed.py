"""The port's collective layer against the JAX package's on the CPU:
``shard_points`` bit for bit, ``DistributedICP`` on a one-rank gloo group
against the JAX ``DistributedICP`` on ``make_mesh(1)`` and against the port's
single-device ``ICPEngine``, and 2 and 4 gloo ranks (spawned processes that
import no JAX) against ``make_mesh(2)`` / ``make_mesh(4)`` and against the
one-rank result.  Tolerances: T and overlap within 1e-4, as
``tests/test_distributed.py`` holds 1 shard against 8."""
import socket
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from norlab_icp_mapper_tpu import se3 as jse3
from norlab_icp_mapper_tpu.parallel import (DistributedICP as JICP,
                                            make_mesh as jmake_mesh,
                                            shard_points as jshard_points)
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch.icp.engine import ICPEngine
from norlab_icp_mapper_tpu_torch.parallel import (DistributedICP, make_mesh,
                                                  multihost, shard_points)

from test_distributed import normals_for, structured_cloud
import torch_dist_worker


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture
def one_rank_group(monkeypatch):
    """A one-rank gloo group in this process, destroyed afterwards."""
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize(f"127.0.0.1:{free_port()}", 1, 0, device="cpu")
    yield make_mesh()
    dist.destroy_process_group()


def case(rng, n=600, xi=(0.03, 0.01, -0.02, 0.01, 0.02, -0.01), n_shards=1,
         max_dist=1.0, max_iter=8):
    cloud = structured_cloud(rng, n=n)
    normals = normals_for(cloud)
    mask = np.ones(cloud.shape[0], bool)
    mask[::17] = False  # a few map points masked out
    T_err = np.asarray(jse3.exp_se3(jnp.asarray(np.float32(xi))))
    moved = (cloud @ T_err[:3, :3].T + T_err[:3, 3]).astype(np.float32)
    read_mask = np.ones(moved.shape[0], bool)
    read_mask[5::23] = False
    mp, mn, mm = shard_points(cloud, normals, mask, n_shards, cell_size=1.0)
    return dict(cloud=cloud, normals=normals, mask=mask, T_err=T_err,
                read_pos=moved, read_mask=read_mask, map_pos=mp,
                map_norm=mn, map_mask=mm, max_dist=max_dist,
                max_iter=max_iter)


def jax_solve(c, n_shards):
    mp, mn, mm = jshard_points(c["cloud"], c["normals"], c["mask"], n_shards,
                               cell_size=1.0)
    icp = JICP(jmake_mesh(n_shards), max_dist=c["max_dist"],
               max_iter=c["max_iter"])
    T, overlap, rms = icp.solve(jnp.asarray(c["read_pos"]),
                                jnp.asarray(c["read_mask"]), jnp.asarray(mp),
                                jnp.asarray(mn), jnp.asarray(mm))
    return np.asarray(T), float(overlap), float(rms)


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 8])
def test_shard_points_equals_jax(rng, n_shards):
    cloud = rng.uniform(-50, 50, size=(3000, 3)).astype(np.float32)
    normals = rng.normal(size=(3000, 3)).astype(np.float32)
    mask = rng.random(3000) > 0.2
    got = shard_points(cloud, normals, mask, n_shards, cell_size=7.0)
    want = jshard_points(cloud, normals, mask, n_shards, cell_size=7.0)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_one_rank_recovers_a_known_transform(rng, one_rank_group):
    """``tests/test_distributed.py``'s known-transform case on one rank."""
    c = case(rng, n=900, xi=(0.05, -0.03, 0.02, 0.02, -0.01, 0.03),
             max_iter=15)
    icp = DistributedICP(one_rank_group, max_dist=1.0, max_iter=15)
    blocks = [multihost.make_global_array(c[k], one_rank_group)
              for k in ("map_pos", "map_norm", "map_mask")]
    T, overlap, rms = icp.solve(c["read_pos"], c["read_mask"], *blocks)
    np.testing.assert_allclose(T.numpy() @ c["T_err"], np.eye(4), atol=5e-3)
    assert float(overlap) > 0.9 and float(rms) < 0.02
    Tj, oj, rj = jax_solve(c, 1)
    np.testing.assert_allclose(T.numpy(), Tj, atol=1e-4)
    assert abs(float(overlap) - oj) < 1e-4
    assert abs(float(rms) - rj) < 1e-4


@pytest.mark.parametrize("max_iter", [0, 1, 8])
def test_one_rank_matches_jax(rng, one_rank_group, max_iter):
    c = case(rng, max_iter=max_iter)
    icp = DistributedICP(one_rank_group, max_dist=1.0, max_iter=max_iter)
    # a rank's block may come as [1, cap, D] or as [cap, D]
    T, overlap, rms = icp.solve(c["read_pos"], c["read_mask"],
                                c["map_pos"][0], c["map_norm"][0],
                                c["map_mask"][0])
    Tj, oj, rj = jax_solve(c, 1)
    np.testing.assert_allclose(T.numpy(), Tj, atol=1e-4)
    assert abs(float(overlap) - oj) < 1e-4
    assert abs(float(rms) - rj) < 1e-4


ENGINE_FORMS = {
    # 1-NN within maxDist as the bounded sweep matcher ...
    "sweep_matcher": {"matcher": {"KDTreeMatcher": {"knn": 1,
                                                    "maxDist": 1.0}}},
    # ... and as the brute-force matcher with a MaxDist outlier filter
    "brute_force_maxdist_filter": {
        "matcher": {"KDTreeMatcher": {"knn": 1}},
        "outlierFilters": [{"MaxDistOutlierFilter": {"maxDist": 1.0}}]},
}


@pytest.mark.parametrize("form", sorted(ENGINE_FORMS))
def test_one_rank_matches_the_single_device_engine(rng, one_rank_group,
                                                   monkeypatch, form):
    """The port's ``ICPEngine`` with the same setup: 1-NN within
    ``maxDist``, point-to-plane, a counter of 15 iterations, matches
    recomputed every iteration (``NIM_TPU_REMATCH_EVERY=1``)."""
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "1")
    c = case(rng, n=900, max_iter=15)
    T, _, _ = DistributedICP(one_rank_group, max_dist=1.0,
                             max_iter=15).solve(
        c["read_pos"], c["read_mask"], c["map_pos"], c["map_norm"],
        c["map_mask"])
    eng = ICPEngine(dict(ENGINE_FORMS[form],
                         errorMinimizer="PointToPlaneErrorMinimizer",
                         transformationCheckers=[
                             {"CounterTransformationChecker":
                              {"maxIterationCount": 15}}]))
    ref = nt.PointBatch(torch.from_numpy(c["cloud"]),
                        torch.from_numpy(c["mask"]))
    out = eng.solve(torch.from_numpy(c["read_pos"]),
                    torch.from_numpy(c["read_mask"]), ref.positions,
                    torch.from_numpy(c["normals"]), ref.mask,
                    eng.build_ref_pack(ref))
    assert int(out.iterations) == 15
    assert int(eng.last_overflow) == 0
    np.testing.assert_allclose(T.numpy(), out.correction.numpy(), atol=1e-4)


def test_2d(rng, one_rank_group):
    pts = np.concatenate([
        np.column_stack([rng.uniform(-4, 4, 150), np.full(150, -2.0)]),
        np.column_stack([np.full(150, 3.0), rng.uniform(-2, 2, 150)]),
        np.column_stack([rng.uniform(-4, 4, 150), np.full(150, 2.0)]),
        np.column_stack([np.full(150, -3.5), rng.uniform(-2, 2, 150)]),
    ]).astype(np.float32)
    nrm = np.zeros_like(pts)
    nrm[:150, 1] = nrm[300:450, 1] = 1
    nrm[150:300, 0] = nrm[450:, 0] = 1
    c, s = np.cos(0.03), np.sin(0.03)
    moved = (pts @ np.array([[c, -s], [s, c]], np.float32).T
             + np.float32([0.05, -0.04]))
    mp, mn, mm = shard_points(pts, nrm, np.ones(600, bool), 1)
    T, overlap, _ = DistributedICP(one_rank_group, 1.0, 10).solve(
        moved, np.ones(600, bool), mp, mn, mm)
    Tj, oj, _ = (np.asarray(x) for x in JICP(jmake_mesh(1), 1.0, 10).solve(
        jnp.asarray(moved), jnp.ones(600, bool), jnp.asarray(mp),
        jnp.asarray(mn), jnp.asarray(mm)))
    assert T.shape == (3, 3)
    np.testing.assert_allclose(T.numpy(), Tj, atol=1e-4)
    assert abs(float(overlap) - float(oj)) < 1e-4


def test_mesh_and_initialize_refusals(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="initialize"):
        make_mesh()
    # one process, no coordinator: nothing to do
    multihost.initialize(device="cpu")
    assert not dist.is_initialized()
    assert multihost.process_count() == 1 and multihost.process_index() == 0
    with pytest.raises(ValueError, match="RANK"):
        multihost.initialize(num_processes=2, device="cpu")


def test_one_rank_mesh_size_is_checked(one_rank_group):
    assert one_rank_group.device_type == "cpu"
    assert one_rank_group.mesh_dim_names == ("cells",)
    with pytest.raises(ValueError, match="ranks"):
        make_mesh(2)


def test_entry_points_default_to_the_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    with pytest.raises(RuntimeError, match="cuda"):
        multihost.initialize()
    mesh = types.SimpleNamespace(device_type="cuda",
                                 get_group=lambda axis: None)
    with pytest.raises(RuntimeError, match="cuda"):
        DistributedICP(mesh)


@pytest.mark.parametrize("world", [2, 4])
def test_spawned_ranks_match_jax_and_one_rank(rng, tmp_path, world,
                                              one_rank_group):
    """``world`` gloo ranks in spawned processes (torchrun's environment
    variables, ``initialize``, ``make_mesh``, ``make_global_array``): every
    rank returns the same T, within 1e-4 of the JAX ``DistributedICP`` on
    ``make_mesh(world)`` and of the port's one-rank result."""
    c = case(rng, n=900, n_shards=world, max_iter=10)
    job = {k: c[k] for k in ("read_pos", "read_mask", "map_pos", "map_norm",
                             "map_mask", "max_dist", "max_iter")}
    tmp.spawn(torch_dist_worker.run_rank,
              args=(world, free_port(), str(tmp_path), job), nprocs=world,
              join=True)
    res = [np.load(tmp_path / f"rank{r}.npz") for r in range(world)]
    for r, out in enumerate(res):
        assert int(out["process_count"]) == world
        assert int(out["process_index"]) == r
        assert bool(out["block_is_own_shard"])
        assert list(out["block_dtypes"]) == ["torch.float32", "torch.float32",
                                             "torch.bool"]
        assert not bool(out["jax_imported"])
        np.testing.assert_array_equal(out["T"], res[0]["T"])
        assert float(out["overlap"]) == float(res[0]["overlap"])
    Tj, oj, _ = jax_solve(c, world)
    np.testing.assert_allclose(res[0]["T"], Tj, atol=1e-4)
    assert abs(float(res[0]["overlap"]) - oj) < 1e-4
    # the same reading against the whole map on this process's one rank
    whole = shard_points(c["cloud"], c["normals"], c["mask"], 1,
                         cell_size=1.0)
    T1, o1, _ = DistributedICP(one_rank_group, max_dist=1.0,
                               max_iter=10).solve(c["read_pos"],
                                                  c["read_mask"], *whole)
    np.testing.assert_allclose(res[0]["T"], T1.numpy(), atol=1e-4)
    assert abs(float(res[0]["overlap"]) - float(o1)) < 1e-4
