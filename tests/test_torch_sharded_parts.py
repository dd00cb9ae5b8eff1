"""The sharded mapper's parts against the JAX package's, in one process on
the CPU: the bucket hash, the table and its moves, ``ShardedMapConfig``,
the window, the scatter insert and the halo packing bit for bit; the
facade's plugin mapping and refusals on a one-rank gloo group; and where
``Mapper(mesh=...)`` puts its blocks."""
import copy
import types

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import norlab_icp_mapper_tpu as nj
from norlab_icp_mapper_tpu.parallel import (ShardedMapConfig as JCfg,
                                            ShardedMapperStep as JStep,
                                            make_mesh as jmake_mesh)
from norlab_icp_mapper_tpu.parallel import sharded_map as jsm
import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch.parallel import (ShardedMapConfig,
                                                  ShardedMapper,
                                                  ShardedMapperStep)
from norlab_icp_mapper_tpu_torch.parallel import sharded_map as tsm

from test_sharded_mapper import OPTS, SHARDED_CONFIG
from test_torch_distributed import free_port, one_rank_group  # noqa: F401


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and small CPU ops split over every core slow down by an order of
    magnitude when the cores are shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _coords(rng, kind, n=4000, dim=3):
    if kind == "local":
        return rng.uniform(-50, 50, size=(n, dim)).astype(np.float32)
    if kind == "negative":
        return rng.uniform(-1e5, -1e-3, size=(n, dim)).astype(np.float32)
    # huge: beyond int32 cells, infinities and NaN among ordinary values
    x = rng.uniform(-3e11, 3e11, size=(n, dim)).astype(np.float32)
    x[::7] = rng.uniform(-9, 9, size=x[::7].shape)
    x[1, 0], x[2, 1], x[3, 0] = np.inf, -np.inf, np.nan
    return x


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["local", "negative", "huge"])
@pytest.mark.parametrize("cell,B", [(4.8, 4096), (1.2, 1000), (0.3, 7)])
def test_bucket_hash_bit_for_bit(rng, dim, kind, cell, B):
    """The int64 hash equals numpy's uint32 hash everywhere, and the JAX
    device hash wherever the cell index fits in int32 (XLA's conversion
    of an out-of-range float is its own)."""
    pos = _coords(rng, kind, dim=dim)
    want = jsm._bucket_np(pos, cell, B)
    np.testing.assert_array_equal(tsm._bucket_np(pos, cell, B), want)
    got = tsm._bucket_torch(torch.from_numpy(pos), cell, B).numpy()
    np.testing.assert_array_equal(got, want)
    if kind != "huge":
        np.testing.assert_array_equal(
            np.asarray(jsm._bucket_jnp(jnp.asarray(pos), cell, B)), want)


@pytest.mark.parametrize("S", [1, 2, 3, 8])
def test_greedy_table_and_incremental_moves_equal_jax(rng, S):
    w = rng.integers(0, 500, size=512).astype(np.int64)
    w[rng.random(512) < 0.4] = 0
    np.testing.assert_array_equal(tsm.greedy_table(w, S),
                                  jsm.greedy_table(w, S))
    skew = np.zeros(512, np.int32)  # every bucket on rank 0
    for target in (0.9, 0.98):
        a = tsm.incremental_moves(w, skew, S, target)
        b = jsm.incremental_moves(w, skew, S, target)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


CONFIG_CASES = [
    dict(),
    dict(cell_size=2.0, voxel_size=0.3),
    dict(cell_size=5.0, voxel_size=0.15, max_point_by_node=4),
    dict(cell_size=4.8, voxel_size=0.0),
    dict(trimmed_ratio=0.8),
    dict(outlier_filters=(("maxdist", 0.8), ("median", 3.0),
                          ("trimmed", 0.95), ("normal", 1.3))),
    dict(diff_checker=(0.001, 0.002, 4), bound_checker=(1, 2.0),
         inspect=True, dynamic_points={"alpha": 0.8}),
]


@pytest.mark.parametrize("kw", CONFIG_CASES, ids=str)
def test_config_equals_jax(kw):
    a, b = vars(ShardedMapConfig(**kw)), vars(JCfg(**kw))
    assert a == b


def test_window_equals_jax(rng):
    """The same pose sequence (steps, a jump, a return) through both
    windows: edges, moves, boxes and grid bounds equal, in 3-D and 2-D."""
    for dim in (3, 2):
        wt, wj = tsm._Window(dim, 15.0), jsm._Window(dim, 15.0)
        x = np.cumsum(rng.uniform(0, 9, 40))
        x[20:] -= 300.0  # a jump back
        for i, px in enumerate(x):
            T = np.eye(dim + 1, dtype=np.float32)
            T[0, dim], T[1, dim] = px, 0.4 * i
            if i == 0:
                wt.first(T)
                wj.first(T)
            assert wt.advance(T) == wj.advance(T)
            assert wt.w == wj.w
            for u, v in zip(wt.box(), wj.box()):
                np.testing.assert_array_equal(u, v)
            assert wt.grid_bounds() == wj.grid_bounds()


def _block(rng, cap=512, n_valid=300, dim=3):
    msk = np.zeros(cap, bool)
    msk[rng.choice(cap, n_valid, replace=False)] = True
    return (rng.normal(size=(cap, dim)).astype(np.float32),
            rng.normal(size=(cap, dim)).astype(np.float32), msk,
            rng.random(cap).astype(np.float32))


@pytest.mark.parametrize("n_take", [0, 40, 212, 300])
def test_scatter_insert_equals_jax(rng, n_take):
    """Free slots first in slot order, takers in row order, overflow
    dropped and counted (300 takers for 212 free slots overflow)."""
    pos, nrm, msk, prob = _block(rng)
    n = 400
    new_pos = rng.normal(size=(n, 3)).astype(np.float32)
    new_nrm = rng.normal(size=(n, 3)).astype(np.float32)
    new_prob = rng.random(n).astype(np.float32)
    take = np.zeros(n, bool)
    take[rng.choice(n, n_take, replace=False)] = True
    args = (pos, nrm, msk, prob, new_pos, new_nrm, new_prob, take)
    want = JStep._scatter_insert(*map(jnp.asarray, args))
    got = ShardedMapperStep._scatter_insert(*map(torch.from_numpy, args))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _jax_compact_halo(H):
    """The JAX package's ``compact_halo``: a closure of its merge body."""
    cfg = JCfg(halo_capacity=H)
    merge_update = JStep(jmake_mesh(1), cfg)._shared_kernels()[2]
    cells = dict(zip(merge_update.__code__.co_freevars,
                     (c.cell_contents for c in merge_update.__closure__)))
    return cells["compact_halo"]


@pytest.mark.parametrize("H", [64, 1024])
def test_compact_halo_equals_jax(rng, H):
    pos, _, msk, prob = _block(rng)
    sel = rng.random(pos.shape[0]) < 0.5
    want = _jax_compact_halo(H)(*map(jnp.asarray, (pos, msk, prob, sel)))
    got = ShardedMapperStep._compact_halo(
        *map(torch.from_numpy, (pos, msk, prob, sel)), H)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------- the facade's mapping

def _same_config(ct, cj):
    a, b = dict(vars(ct)), dict(vars(cj))
    ft, fj = a.pop("step_filter"), b.pop("step_filter")
    assert (ft is None) == (fj is None)
    assert a == b


@pytest.mark.parametrize("name", ["config.yaml", "config_p2plane.yaml"])
def test_example_configs_construct_on_mesh(one_rank_group, name):
    """The bundled configs construct the sharded backend unmodified, into
    the config the JAX package derives from them."""
    mt = nt.Mapper(f"examples/{name}", device="cpu", mesh=one_rank_group,
                   sharded_options=OPTS)
    mj = nj.Mapper(f"examples/{name}", mesh=jmake_mesh(1),
                   sharded_options=OPTS)
    assert mt._sharded is not None
    assert mt._sharded.cfg.dynamic_points is not None
    assert mt._sharded.cfg.cut_threshold == 0.65
    _same_config(mt._sharded.cfg, mj._sharded.cfg)
    assert mt.trajectory is mt._sharded.trajectory
    assert mt._sharded.device == torch.device("cpu")


def test_sharded_config_mapping_equals_jax(one_rank_group):
    cfg = copy.deepcopy(SHARDED_CONFIG)
    cfg["icp"]["readingStepDataPointsFilters"] = [
        {"RandomSamplingDataPointsFilter": {"prob": 0.8}}]
    cfg["icp"]["transformationCheckers"].append(
        {"BoundTransformationChecker": {"maxRotationNorm": 1.0,
                                        "maxTranslationNorm": 0.05}})
    cfg["icp"]["inspector"] = "PerformanceInspector"
    mt = nt.Mapper(copy.deepcopy(cfg), device="cpu", mesh=one_rank_group,
                   sharded_options=OPTS)
    mj = nj.Mapper(copy.deepcopy(cfg), mesh=jmake_mesh(1),
                   sharded_options=OPTS)
    _same_config(mt._sharded.cfg, mj._sharded.cfg)
    assert mt._sharded.inspector is mt.icp.inspector


def _refused(cfg):
    return copy.deepcopy(cfg)


def test_unsupported_config_raises(one_rank_group):
    cfg = _refused(SHARDED_CONFIG)
    cfg["post"].append({"OrientNormalsDataPointsFilter": {"towardCenter": 1}})
    with pytest.raises(NotImplementedError, match="OrientNormals"):
        nt.Mapper(cfg, device="cpu", mesh=one_rank_group,
                  sharded_options=OPTS)
    cfg = _refused(SHARDED_CONFIG)
    cfg["mapper"]["mapperModule"].reverse()  # Octree before DynamicPoints
    with pytest.raises(NotImplementedError, match="must precede"):
        nt.Mapper(cfg, device="cpu", mesh=one_rank_group,
                  sharded_options=OPTS)
    cfg = _refused(SHARDED_CONFIG)
    cfg["icp"]["inspector"] = {"VTKFileInspector":
                               {"baseFileName": "/tmp/insp"}}
    with pytest.raises(NotImplementedError, match="VTKFileInspector"):
        nt.Mapper(cfg, device="cpu", mesh=one_rank_group,
                  sharded_options=OPTS)


@pytest.mark.parametrize("section", ["readingDataPointsFilters",
                                     "readingStepDataPointsFilters"])
def test_position_editing_reading_filter_raises(one_rank_group, section):
    """Reading filters run as a registration mask: a centroid-replacing
    filter edits geometry and is refused."""
    cfg = _refused(SHARDED_CONFIG)
    cfg["icp"][section] = [
        {"OctreeGridDataPointsFilter": {"maxSizeByNode": 0.5,
                                        "samplingMethod": 2}}]
    with pytest.raises(NotImplementedError, match="samplingMethod=2"):
        nt.Mapper(cfg, device="cpu", mesh=one_rank_group,
                  sharded_options=OPTS)


def test_mesh_defaults_to_the_card_and_checks_the_device(one_rank_group):
    """``Mapper(mesh=...)`` puts the blocks on the card unless told
    otherwise, and raises without one; a device the mesh contradicts and
    a mesh that is no DeviceMesh raise."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="cuda"):
        nt.Mapper(copy.deepcopy(SHARDED_CONFIG), mesh=one_rank_group,
                  sharded_options=OPTS)
    with pytest.raises(RuntimeError, match="cuda"):
        ShardedMapper(one_rank_group, ShardedMapConfig())
    nccl_mesh = types.SimpleNamespace(device_type="cuda",
                                      get_group=lambda axis: None)
    with pytest.raises(ValueError, match="contradicts"):
        tsm.shard_device(nccl_mesh, "cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        nt.Mapper(None, device="cpu", mesh=object())
    sm = ShardedMapper(one_rank_group, ShardedMapConfig(), device="cpu")
    assert sm.step.n_shards == 1 and sm.step.rank == 0
    assert sm.table.device.type == "cpu"


def test_init_state_and_convert_equal_jax(rng, one_rank_group):
    """The first scan packed into the rank's block (``init_state``) equals
    the JAX package's block bit for bit, and ``convert`` carries the JAX
    package's blocks and table over unchanged."""
    from norlab_icp_mapper_tpu_torch import convert
    pos = rng.uniform(-20, 20, size=(3000, 3)).astype(np.float32)
    desc = {"normals": rng.normal(size=(3000, 3)).astype(np.float32),
            "probabilityDynamic": rng.random((3000, 1)).astype(np.float32)}
    cfg = dict(cell_size=2.0, n_buckets=512)
    table = tsm.greedy_table(np.bincount(
        tsm._bucket_np(pos, ShardedMapConfig(**cfg).cell_size, 512),
        minlength=512), 1)
    js = JStep(jmake_mesh(1), JCfg(**cfg)).init_state(
        nj.PointBatch.from_numpy(pos, desc), table)
    ts = ShardedMapperStep(one_rank_group, ShardedMapConfig(**cfg),
                           device="cpu").init_state(
        nt.PointBatch.from_numpy(pos, desc, device="cpu"), table)
    blocks = {k: np.asarray(v) for k, v in js.items()}
    for k in blocks:
        np.testing.assert_array_equal(ts[k].numpy(), blocks[k][0])
    state, tab = convert.sharded_state_from_numpy(blocks, table,
                                                  one_rank_group, "cpu")
    for k in blocks:
        assert state[k].dtype == ts[k].dtype
        np.testing.assert_array_equal(state[k].numpy(), blocks[k][0])
    np.testing.assert_array_equal(tab.numpy(), table)
    with pytest.raises(ValueError, match="blocks"):
        convert.sharded_state_from_numpy(
            {k: np.concatenate([v, v]) for k, v in blocks.items()}, table,
            one_rank_group, "cpu")
