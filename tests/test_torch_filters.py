"""Port parity: the ported DataPointsFilters and FilterChains of the bundled
configs against the JAX package (CPU), same numpy clouds through both."""
import numpy as np
import pytest
import yaml
import jax
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu import PointBatch as JBatch
from norlab_icp_mapper_tpu.filters import core as jf
from norlab_icp_mapper_tpu_torch import PointBatch as TBatch, DrawSource
from norlab_icp_mapper_tpu_torch.filters import core as tf
from norlab_icp_mapper_tpu_torch.draws import SITE_RANDOM_SAMPLING


def _surface_cloud(rng, n, dim=3):
    """Points on a floor and a wall, with 5 mm of noise: normals are well
    defined."""
    if dim == 2:
        x = rng.uniform(-4, 4, n)
        pts = np.column_stack([x, np.where(rng.random(n) < 0.5, 0.0, 2.0)])
    else:
        half = n // 2
        floor = np.column_stack([rng.uniform(-4, 4, half),
                                 rng.uniform(-4, 4, half), np.zeros(half)])
        wall = np.column_stack([rng.uniform(-4, 4, n - half),
                                np.full(n - half, 4.0),
                                rng.uniform(0, 3, n - half)])
        pts = np.concatenate([floor, wall])
    return (pts + rng.normal(scale=0.005, size=pts.shape)).astype(np.float32)


def _both(pts, desc=None):
    return (JBatch.from_numpy(pts, desc),
            TBatch.from_numpy(pts, desc, device="cpu"))


CASES = [
    ("BoundingBoxDataPointsFilter",
     dict(xMin=-1.5, xMax=0.5, yMin=-1, yMax=1, zMin=-1, zMax=0.5,
          removeInside=1)),
    ("BoundingBoxDataPointsFilter",
     dict(xMin=-2, xMax=2, yMin=-2, yMax=2, zMin=-1, zMax=1,
          removeInside=0)),
    ("DistanceLimitDataPointsFilter", dict(dim=-1, dist=3.0, removeInside=0)),
    ("DistanceLimitDataPointsFilter", dict(dim=-1, dist=2.0, removeInside=1)),
    ("DistanceLimitDataPointsFilter", dict(dim=0, dist=1.0, removeInside=1)),
    ("AddDescriptorDataPointsFilter",
     dict(descriptorName="probabilityDynamic", descriptorDimension=1,
          descriptorValues=[0.6])),
    ("AddDescriptorDataPointsFilter",
     dict(descriptorName="rgb", descriptorDimension=3,
          descriptorValues="[0.1, 0.2, 0.3]")),
    ("CutAtDescriptorThresholdDataPointsFilter",
     dict(descName="p", useLargerThan=1, threshold=0.65)),
    ("CutAtDescriptorThresholdDataPointsFilter",
     dict(descName="p", useLargerThan=0, threshold=0.3)),
]


@pytest.mark.parametrize("name,params", CASES,
                         ids=[f"{c[0][:12]}{i}" for i, c in enumerate(CASES)])
def test_elementwise_filters_match(rng, name, params):
    pts = rng.uniform(-4, 4, size=(500, 3)).astype(np.float32)
    desc = {"p": rng.random(500).astype(np.float32)}
    bj, bt = _both(pts, desc)
    oj = jf.filter_registry.create(name, dict(params)).apply(bj)
    ot = tf.filter_registry.create(name, dict(params)).apply(bt)
    # comparisons and constants only: exact
    np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
    assert sorted(ot.descriptors) == sorted(oj.descriptors)
    for k in oj.descriptors:
        np.testing.assert_array_equal(ot.descriptors[k].numpy(),
                                      np.asarray(oj.descriptors[k]))


def test_random_sampling_with_injected_draws(rng):
    pts = rng.uniform(-4, 4, size=(700, 3)).astype(np.float32)
    bj, bt = _both(pts)
    key = jax.random.PRNGKey(11)
    u = np.asarray(jax.random.uniform(key, (bj.capacity,)))
    oj = jf.filter_registry.create(
        "RandomSamplingDataPointsFilter", {"prob": 0.5}).apply(bj, key)
    seen = []

    def source(site, n):
        seen.append((site, n))
        return torch.from_numpy(u.copy())

    ot = tf.filter_registry.create(
        "RandomSamplingDataPointsFilter", {"prob": 0.5}).apply(
            bt, DrawSource(0, "cpu", source))
    np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
    assert seen == [(SITE_RANDOM_SAMPLING, bt.capacity)]
    # prob 1.0 keeps every valid point whatever the draws
    keep_all = tf.filter_registry.create(
        "RandomSamplingDataPointsFilter", {"prob": 1.0}).apply(
            bt, DrawSource(3, "cpu"))
    np.testing.assert_array_equal(keep_all.mask.numpy(), bt.mask.numpy())
    # the generator path keeps about prob of the points, reproducibly
    a = tf.filter_registry.create(
        "RandomSamplingDataPointsFilter", {"prob": 0.5}).apply(
            bt, DrawSource(5, "cpu"))
    b = tf.filter_registry.create(
        "RandomSamplingDataPointsFilter", {"prob": 0.5}).apply(
            bt, DrawSource(5, "cpu"))
    assert bool((a.mask == b.mask).all())
    assert 0.4 < float(a.mask.sum()) / 700 < 0.6


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("extras", [False, True])
def test_surface_normal_radius_engine(rng, dim, extras):
    pts = _surface_cloud(rng, 900, dim)
    # two isolated points: degenerate neighbourhoods take the fallback
    pts[:2] = np.array([[40.0, 40.0, 40.0][:dim], [-40.0, 40.0, 9.0][:dim]],
                       np.float32)
    params = dict(knn=10, maxDist=1.0, keepDensities=int(extras),
                  keepEigenValues=int(extras))
    bj, bt = _both(pts)
    oj = jf.filter_registry.create("SurfaceNormalDataPointsFilter",
                                   dict(params)).apply(bj)
    f = tf.filter_registry.create("SurfaceNormalDataPointsFilter",
                                  dict(params))
    ot = f.apply(bt)
    assert int(f.last_overflow) == 0
    nj = np.asarray(oj.descriptors["normals"])[:900]
    nt = ot.descriptors["normals"].numpy()[:900]
    np.testing.assert_allclose(np.linalg.norm(nt, axis=1), 1.0, atol=1e-5)
    # degenerate fallback: unit vector along the last axis, in both
    fb = np.zeros(dim, np.float32)
    fb[-1] = 1
    np.testing.assert_array_equal(nt[:2], np.tile(fb, (2, 1)))
    np.testing.assert_array_equal(nj[:2], np.tile(fb, (2, 1)))
    # the reference's CPU engine gates on the expanded-form distance, so a
    # neighbour within rounding of the radius may be counted differently:
    # one neighbour in ~100 moves a normal by ~1e-3 at worst.  Same sign
    # convention in both (same closed form).
    cos = np.sum(nj * nt, axis=1)
    assert (cos > 1 - 1e-4).mean() > 0.99
    assert (np.abs(cos) > 1 - 1e-3).all()
    if extras:
        np.testing.assert_allclose(
            ot.descriptors["densities"].numpy()[:900],
            np.asarray(oj.descriptors["densities"])[:900], rtol=0.03)
        ej = np.asarray(oj.descriptors["eigValues"])[:900]
        et = ot.descriptors["eigValues"].numpy()[:900]
        np.testing.assert_allclose(et, ej, atol=5e-3)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("knn", [3, 10])
def test_surface_normal_radius_engine_is_one_pass_of_the_normals_sibling(
        rng, dim, knn):
    """With a finite ``maxDist`` the filter's descriptors are the outputs of
    one ``radius_pca_normals`` call (count, eigenvalues, normals with the
    degenerate rule at min(knn, 3)), at the points' own rows of a masked
    batch."""
    from norlab_icp_mapper_tpu_torch.ops import pca as tpca
    pts = _surface_cloud(rng, 700, dim)
    pts[:2] = np.array([[40.0, 40.0, 40.0][:dim], [40.3, 40.0, 40.1][:dim]],
                       np.float32)
    bt = TBatch.from_numpy(pts, device="cpu")
    bt = bt.with_mask(bt.mask & torch.from_numpy(
        rng.random(bt.capacity) > 0.2))
    f = tf.filter_registry.create(
        "SurfaceNormalDataPointsFilter",
        dict(knn=knn, maxDist=0.8, keepDensities=1, keepEigenValues=1))
    calls = []
    real = tpca.radius_pca_normals

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    tpca.radius_pca_normals = spy
    try:
        out = f.apply(bt)
    finally:
        tpca.radius_pca_normals = real
    assert len(calls) == 1 and calls[0]["min_count"] == min(knn, 3)
    cnt, evals, normals, ov = real(bt.positions, bt.positions, bt.mask,
                                   bt.mask, max_radius=0.8, q_tile=1024,
                                   W=2048, min_count=min(knn, 3))
    assert int(f.last_overflow) == int(ov) == 0
    np.testing.assert_array_equal(out.descriptors["normals"].numpy(),
                                  normals.numpy())
    np.testing.assert_array_equal(out.descriptors["eigValues"].numpy(),
                                  evals.numpy())
    vol = 4.0 / 3.0 * np.pi * 0.8 ** 3 if dim == 3 else np.pi * 0.8 ** 2
    np.testing.assert_allclose(out.descriptors["densities"].numpy()[:, 0],
                               cnt.numpy() / vol, rtol=1e-6)
    # the isolated pair has 2 neighbours < min(knn, 3): the rule's normal
    fb = np.zeros(dim, np.float32)
    fb[-1] = 1
    pair = bt.mask.numpy()[:2]
    assert (normals.numpy()[:2][pair] == fb).all()
    # masked-out rows carry nothing
    assert not normals.numpy()[~bt.mask.numpy()].any()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("knn,extras", [(5, False), (10, True)])
def test_surface_normal_knn_engine(rng, dim, knn, extras):
    """``maxDist = inf``: PCA over the k nearest neighbours (the cloud
    searched against itself).  The reference's CPU search ranks by the
    expanded-form distance, so where the k-th and (k+1)-th neighbours lie
    within its rounding of each other the two packages may fit another
    tenth neighbour: normals compared sign-free (an eigenvector has no
    sign), 99 % within |cos| > 1 - 1e-4 and all within 1 - 1e-2."""
    n = 800
    pts = _surface_cloud(rng, n, dim)
    bj, bt = _both(pts)
    holes = np.ones(bj.capacity, bool)
    holes[rng.integers(0, n, 60)] = False
    bj = bj.with_mask(jnp.asarray(holes))
    bt = bt.with_mask(torch.from_numpy(holes))
    params = dict(knn=knn, keepDensities=int(extras),
                  keepEigenValues=int(extras))
    oj = jf.filter_registry.create("SurfaceNormalDataPointsFilter",
                                   dict(params)).apply(bj)
    ot = tf.filter_registry.create("SurfaceNormalDataPointsFilter",
                                   dict(params)).apply(bt)
    valid = np.asarray(oj.mask)
    np.testing.assert_array_equal(ot.mask.numpy(), valid)
    nj = np.asarray(oj.descriptors["normals"])[valid]
    nt = ot.descriptors["normals"].numpy()[valid]
    np.testing.assert_allclose(np.linalg.norm(nt, axis=1), 1.0, atol=1e-5)
    cos = np.abs(np.sum(nj * nt, axis=1))
    assert (cos > 1 - 1e-4).mean() > 0.99
    assert (cos > 1 - 1e-2).all()
    # the surfaces are a floor and a wall (lines in 2-D): most normals
    # point along an axis
    assert (np.abs(nt).max(axis=1) > 0.95).mean() > 0.9
    if extras:
        # density = k / volume of the k-ball: r^3 triples the relative
        # error of the k-th distance
        np.testing.assert_allclose(
            ot.descriptors["densities"].numpy()[valid],
            np.asarray(oj.descriptors["densities"])[valid], rtol=2e-2)
        np.testing.assert_allclose(
            ot.descriptors["eigValues"].numpy()[valid],
            np.asarray(oj.descriptors["eigValues"])[valid], atol=1e-4)


def test_surface_normal_knn_engine_with_fewer_than_k_points(rng):
    """Four valid points and knn = 10: the rows of the search end in -1, and
    both packages fit the four points they have."""
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    bj, bt = _both(pts)
    mask = np.zeros(bj.capacity, bool)
    mask[[3, 9, 21, 30]] = True
    oj = jf.filter_registry.create(
        "SurfaceNormalDataPointsFilter", {"knn": 10, "keepEigenValues": 1}
    ).apply(bj.with_mask(jnp.asarray(mask)))
    ot = tf.filter_registry.create(
        "SurfaceNormalDataPointsFilter", {"knn": 10, "keepEigenValues": 1}
    ).apply(bt.with_mask(torch.from_numpy(mask)))
    nj = np.asarray(oj.descriptors["normals"])[mask]
    nt = ot.descriptors["normals"].numpy()[mask]
    assert (np.abs(np.sum(nj * nt, axis=1)) > 1 - 1e-4).all()
    # all four points see the same four neighbours: one normal
    assert (np.abs(nt @ nt[0]) > 1 - 1e-4).all()
    np.testing.assert_allclose(ot.descriptors["eigValues"].numpy()[mask],
                               np.asarray(oj.descriptors["eigValues"])[mask],
                               atol=1e-5)


def _bundled(section, name="config.yaml"):
    with open(f"examples/{name}") as fh:
        return yaml.safe_load(fh)[section]


def test_bundled_input_chain_matches(rng):
    pts = rng.uniform(-8, 8, size=(2000, 3)).astype(np.float32)
    bj, bt = _both(pts)
    oj = jf.FilterChain.from_yaml(_bundled("input")).apply(bj)
    chain = tf.FilterChain.from_yaml(_bundled("input"))
    assert len(chain) == 3
    ot = chain.apply(bt)
    np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
    np.testing.assert_array_equal(
        ot.descriptors["probabilityDynamic"].numpy(),
        np.asarray(oj.descriptors["probabilityDynamic"]))
    assert 0 < int(ot.count()) < 2000


def test_bundled_post_chain_matches(rng):
    pts = _surface_cloud(rng, 1200)
    prob = rng.uniform(0.4, 0.9, size=1200).astype(np.float32)
    bj, bt = _both(pts, {"probabilityDynamic": prob})
    oj = jf.FilterChain.from_yaml(_bundled("post")).apply(bj)
    ot = tf.FilterChain.from_yaml(_bundled("post")).apply(bt)
    np.testing.assert_array_equal(ot.mask.numpy(), np.asarray(oj.mask))
    assert int(ot.count()) == int((prob <= 0.65).sum())
    cos = np.sum(np.asarray(oj.descriptors["normals"])
                 * ot.descriptors["normals"].numpy(), axis=1)[:1200]
    assert (cos > 1 - 1e-4).mean() > 0.99


def test_chain_errors_and_queued_features():
    assert len(tf.FilterChain.from_yaml(None)) == 0
    with pytest.raises(ValueError, match="YAML list"):
        tf.FilterChain.from_yaml({"a": 1})
    # every filter of the zoo is ported; an unknown name gets the
    # registry's usual error
    assert len(tf.FilterChain.from_yaml(["OctreeGridDataPointsFilter"])) == 1
    with pytest.raises(KeyError, match="unknown DataPointsFilter"):
        tf.FilterChain.from_yaml(["NopeDataPointsFilter"])
    with pytest.raises(ValueError, match="unknown parameter"):
        tf.filter_registry.create("BoundingBoxDataPointsFilter", {"foo": 1})
    with pytest.raises(ValueError, match="descriptorValues length"):
        tf.filter_registry.create(
            "AddDescriptorDataPointsFilter",
            dict(descriptorName="a", descriptorDimension=2,
                 descriptorValues=[1.0]))
    bt = TBatch.from_numpy(np.zeros((10, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match="missing descriptor"):
        tf.filter_registry.create(
            "CutAtDescriptorThresholdDataPointsFilter",
            dict(descName="nope")).apply(bt)
    # the k-NN engine of SurfaceNormal on a cloud of one repeated point: a
    # zero covariance takes the eigensolver's fallback, nothing raises
    out = tf.filter_registry.create("SurfaceNormalDataPointsFilter",
                                    {"knn": 5}).apply(bt)
    assert bool(torch.isfinite(out.descriptors["normals"]).all())
