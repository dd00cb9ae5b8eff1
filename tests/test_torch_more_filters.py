"""Port parity: the ten filters of lpm's zoo that neither the bundled
configs nor the default config reach (MaxPointCount, OrientNormals,
OctreeGrid, ObservationDirection, MaxDist, MinDist, Shadow, VoxelGrid,
Identity, RemoveNaN), each through the JAX filter and the port's on the same
numpy cloud, in 2-D and 3-D (CPU).

Points lie strictly inside the 0.5 m voxels of the decimating filters (the
packages may put a point on a voxel face in either voxel); random sampling
gets the JAX draws injected.  Tolerances: masks bit for bit; descriptors
and positions within 1e-6 (the same f32 operations; centroids are segment
sums in another order).
"""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu import PointBatch as JBatch
from norlab_icp_mapper_tpu.filters import core as jf
from norlab_icp_mapper_tpu_torch import PointBatch as TBatch, DrawSource
from norlab_icp_mapper_tpu_torch.filters import core as tf
from norlab_icp_mapper_tpu_torch.draws import SITE_OCTREE_PRIO

CASES = [
    ("MaxPointCountDataPointsFilter", {"maxCount": 300}),
    ("OrientNormalsDataPointsFilter", {"towardCenter": 1}),
    ("OrientNormalsDataPointsFilter", {"towardCenter": 0}),
    ("OctreeGridDataPointsFilter", {"maxSizeByNode": 0.5,
                                    "samplingMethod": 0}),
    ("OctreeGridDataPointsFilter", {"maxSizeByNode": 0.5,
                                    "samplingMethod": 1}),
    ("OctreeGridDataPointsFilter", {"maxSizeByNode": 0.5,
                                    "samplingMethod": 2}),
    ("OctreeGridDataPointsFilter", {"maxSizeByNode": 0.5,
                                    "samplingMethod": 3}),
    ("ObservationDirectionDataPointsFilter", {"x": 0.5, "y": -1.0,
                                              "z": 2.0}),
    ("MaxDistDataPointsFilter", {"dim": -1, "maxDist": 6.0}),
    ("MaxDistDataPointsFilter", {"dim": 0, "maxDist": 1.5}),
    ("MinDistDataPointsFilter", {"dim": -1, "minDist": 4.0}),
    ("MinDistDataPointsFilter", {"dim": 1, "minDist": -2.0}),
    ("ShadowDataPointsFilter", {"eps": 0.3}),
    ("VoxelGridDataPointsFilter", {"vSizeX": 0.5, "vSizeY": 0.5,
                                   "vSizeZ": 0.5, "useCentroid": 1}),
    ("VoxelGridDataPointsFilter", {"vSizeX": 0.5, "vSizeY": 0.5,
                                   "vSizeZ": 0.5, "useCentroid": 0}),
    ("IdentityDataPointsFilter", {}),
    ("RemoveNaNDataPointsFilter", {}),
]


def _cloud(rng, dim, n=1200, with_nan=False):
    cells = np.concatenate([np.repeat(rng.integers(-8, 8, size=(80, dim)),
                                      6, axis=0),
                            rng.integers(-20, 20, size=(n - 480, dim))])
    pts = ((cells + rng.uniform(0.1, 0.9, size=cells.shape)) * 0.5
           ).astype(np.float32)
    if with_nan:
        bad = rng.random(n) < 0.1
        pts[bad, rng.integers(0, dim, size=bad.sum())] = np.nan
        pts[rng.random(n) < 0.02] = np.inf
    nrm = rng.normal(size=(n, dim)).astype(np.float32)
    nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
    mask = rng.random(n) > 0.1
    return pts, mask, nrm


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{n[:-len('DataPointsFilter')]}-{i}"
                              for i, (n, _) in enumerate(CASES)])
def test_filter_matches_jax(rng, case, dim):
    name, params = CASES[case]
    pts, mask, nrm = _cloud(rng, dim, with_nan=name.startswith(
        ("RemoveNaN", "Identity")))
    jb = JBatch(jnp.asarray(pts), jnp.asarray(mask),
                {"normals": jnp.asarray(nrm)})
    tb = TBatch(torch.from_numpy(pts), torch.from_numpy(mask),
                {"normals": torch.from_numpy(nrm)})
    key = jax.random.PRNGKey(11)

    def draws(site, n):
        assert site == SITE_OCTREE_PRIO
        return torch.from_numpy(np.array(jax.random.randint(
            key, (n,), 0, 1 << 15, dtype=jnp.int32)))

    oj = jf.filter_registry.create(name, dict(params)).apply(jb, key)
    ot = tf.filter_registry.create(name, dict(params)).apply(
        tb, DrawSource(0, "cpu", draws))
    np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
    assert sorted(ot.descriptors) == sorted(oj.descriptors)
    m = ot.mask.numpy()
    np.testing.assert_allclose(ot.positions.numpy()[m],
                               np.asarray(oj.positions)[m], atol=1e-6)
    for k, v in ot.descriptors.items():
        np.testing.assert_allclose(v.numpy()[m], np.asarray(oj.descriptors[k])[m],
                                   atol=1e-6)
    if name.startswith("RemoveNaN"):
        assert m.sum() < mask.sum() and np.isfinite(pts[m]).all()
    elif name.startswith("Identity"):
        assert ot is tb
    elif not name.startswith(("OrientNormals", "ObservationDirection")):
        assert 0 < m.sum() < mask.sum()  # the filter really removed points


def test_registry_holds_every_jax_filter():
    assert sorted(tf.filter_registry.names()) \
        == sorted(jf.filter_registry.names())
    assert len(tf.filter_registry.names()) == 16
