"""Port parity: the octree leaf selection with ``maxPointByNode`` = K > 1
(``ops/voxel.py::_octree_select``) against the JAX package's
``voxel_select(max_point_by_node=K)`` on the same numpy inputs (CPU).

Every point lies strictly inside its voxel (at least a tenth of the voxel
from each face): the two packages may disagree on the voxel of a point on a
face, which is not what these tests are about.  Method 1 gets the JAX
draws injected (``prio15`` from the key, the leaf keys from
``fold_in(key, 1)``).  Tolerances: masks bit for bit; centroids within
1e-5 m (segment sums in another order).
"""
import copy

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu.ops import voxel as jv
from norlab_icp_mapper_tpu_torch.ops import voxel as tv

from test_torch_mapper_e2e import (assert_maps_close, bundled, drive_both,
                                   make_world)

VOX = 0.5


def _cloud(rng, dim, n=1500):
    """Dense voxels, sparse clusters that coarsen, isolated points, on both
    sides of the origin, every point strictly inside its voxel."""
    dense = np.repeat(rng.integers(-40, 40, size=(60, dim)), 12, axis=0)
    sparse = rng.integers(-300, 300, size=(n - dense.shape[0], dim))
    cells = np.concatenate([dense, sparse])
    frac = rng.uniform(0.1, 0.9, size=cells.shape)
    pts = ((cells + frac) * VOX).astype(np.float32)
    mask = rng.random(pts.shape[0]) > 0.1
    return pts, mask


def _jax_draws(n):
    key = jax.random.PRNGKey(3)
    prio = np.array(jax.random.randint(key, (n,), 0, 1 << 15,
                                       dtype=jnp.int32))
    leaf = np.array(jax.random.randint(jax.random.fold_in(key, 1), (n,), 0,
                                       jnp.int32(2 ** 30), dtype=jnp.int32))
    return key, prio, leaf


def _both(pts, mask, method, K, levels=10):
    key, prio, leaf = _jax_draws(pts.shape[0])
    kj, cj = jv.voxel_select(jnp.asarray(pts), jnp.asarray(mask), VOX,
                             method=method, key=key, max_point_by_node=K,
                             max_coarsen_levels=levels)
    kt, ct = tv.voxel_select(torch.from_numpy(pts), torch.from_numpy(mask),
                             VOX, method=method,
                             prio15=torch.from_numpy(prio),
                             max_point_by_node=K, max_coarsen_levels=levels,
                             leaf_keys=torch.from_numpy(leaf))
    return np.asarray(kj), np.asarray(cj), kt.numpy(), ct.numpy()


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("K", [2, 4, 8])
@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_octree_select_matches_jax(rng, dim, K, method):
    pts, mask = _cloud(rng, dim)
    kj, cj, kt, ct = _both(pts, mask, method, K)
    np.testing.assert_array_equal(kt, kj)
    assert kt.sum() < (mask.sum() - 60 * 11)  # dense voxels and leaves merge
    assert not (kt & ~mask).any()
    if method in (2, 3):
        np.testing.assert_allclose(ct[kt], cj[kt], atol=1e-5)


@pytest.mark.parametrize("levels", [0, 1, 3, 14, 20])
def test_level_cap_matches_jax(rng, levels):
    pts, mask = _cloud(rng, 3, n=900)
    kj, _, kt, _ = _both(pts, mask, 0, 4, levels)
    np.testing.assert_array_equal(kt, kj)


def test_negative_coordinates_shift_like_jax():
    """``&`` and ``>>`` on int32 in torch are the two's-complement and
    arithmetic-shift operations of ``jnp``: cells straddling the origin
    group as they do in the reference."""
    vc = np.array([[-1, -1, -1], [-2, 0, 5], [-32769, 7, -40000],
                   [32767, -32768, 1]], np.int32)
    for lvl in (0, 1, 3, 14):
        np.testing.assert_array_equal(
            (torch.from_numpy(vc) >> lvl).numpy(),
            np.asarray(jnp.asarray(vc) >> lvl))
    np.testing.assert_array_equal((torch.from_numpy(vc) & 32767).numpy(),
                                  np.asarray(jnp.asarray(vc) & 32767))
    # two points one voxel apart across the origin share the level-1 cell
    # [-2, 0) only on the negative side: K = 2 merges (-1.5, -0.5) but not
    # (-0.5, 0.5)
    pts = np.array([[-0.75, 0.25, 0.25], [-0.25, 0.25, 0.25],
                    [0.25, 5.25, 0.25], [-0.25, 5.25, 0.25]], np.float32)
    _, _, kt, _ = _both(pts, np.ones(4, bool), 0, 2)
    kj, _, _, _ = _both(pts, np.ones(4, bool), 0, 2)
    np.testing.assert_array_equal(kt, kj)
    assert kt[:2].sum() == 1 and kt[2:].sum() == 2


def test_octree_mapper_drive_k4(rng, monkeypatch):
    """The identity config with ``maxPointByNode: 4`` on its
    OctreeMapperModule, first-point sampling (draw-independent), through
    both Mappers: poses to f32 rounding, maps as in the K = 1 drive, and
    a smaller map than K = 1 builds."""
    monkeypatch.setenv("NIM_TPU_REMATCH_EVERY", "3")
    world = make_world(rng)
    cfg = bundled("config.yaml", True)
    for m in cfg["mapper"]["mapperModule"]:
        if "OctreeMapperModule" in m:
            m["OctreeMapperModule"]["maxPointByNode"] = 4
    mj, mt = drive_both(cfg, world, [2.0, 2.5, 3.0], noise=0.02)
    for pj, pt in zip(mj.get_trajectory().poses, mt.get_trajectory().poses):
        np.testing.assert_allclose(pt, pj, atol=1e-5)
    assert_maps_close(mj.get_map(), mt.get_map(), 0.005)
    k1 = nt.Mapper(copy.deepcopy(bundled("config.yaml", True)),
                   device="cpu")
    from test_torch_mapper_e2e import feed, pose_at, scan_at
    for i, x in enumerate([2.0, 2.5, 3.0]):
        feed(k1, nt.PointBatch, scan_at(world, pose_at(x)), pose_at(x),
             i * int(1e8), device="cpu")
    assert mt.get_map()["positions"].shape[0] \
        < k1.get_map()["positions"].shape[0]
