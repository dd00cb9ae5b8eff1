"""Port parity: ``ops/pca.py`` (it holds a kernel).

On the CPU the port's ``radius_pca`` runs its kernel's plain PyTorch version.
It is held against the JAX sweep with the Pallas kernel under
``force_tpu_interpret_mode``, against ``radius_pca_xla``, and against a
float64 numpy oracle.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from norlab_icp_mapper_tpu.ops import pca as jpca
from norlab_icp_mapper_tpu_torch.ops import pca as tpca


def _oracle(q, r, qm, rm, radius):
    q64, r64 = q.astype(np.float64), r.astype(np.float64)
    d2 = ((q64[:, None] - r64[None]) ** 2).sum(-1)
    w = (d2 <= radius * radius) & rm[None] & qm[:, None]
    cnt = w.sum(1).astype(np.float64)
    safe = np.maximum(cnt, 1)
    mean = (w[:, :, None] * r64[None]).sum(1) / safe[:, None]
    dev = (r64[None] - mean[:, None]) * w[:, :, None]
    cov = np.einsum("nkd,nke->nde", dev, dev) / safe[:, None, None]
    return cnt, mean, cov, d2


def _clear_of_gate(d2, radius, width=1e-3):
    """Queries none of whose pairs lies within ``width`` of r^2: the
    reference's XLA path computes the expanded form ``|q|^2+|r|^2-2q.r``,
    whose rounding can put such a pair on the other side of the gate."""
    return ~(np.abs(d2 - radius * radius) < width).any(axis=1)


def _port(q, r, qm, rm, **kw):
    qt, rt = torch.from_numpy(q), torch.from_numpy(r)
    out = tpca.radius_pca(qt, rt, torch.from_numpy(qm), torch.from_numpy(rm),
                          **kw)
    return [o.numpy() for o in out[:3]] + [int(out[3])]


@pytest.mark.parametrize("dim", [2, 3])
def test_two_clouds_against_pallas_interpret_xla_and_oracle(dim):
    rng = np.random.default_rng(20 + dim)
    q = (rng.normal(size=(300, dim)) * 4).astype(np.float32)
    r = (rng.normal(size=(700, dim)) * 4).astype(np.float32)
    qm = rng.random(300) > 0.1
    rm = rng.random(700) > 0.1
    radius = 1.5
    cnt_t, mean_t, cov_t, ov = _port(q, r, qm, rm, max_radius=radius,
                                     q_tile=256, W=700)
    assert ov == 0
    cnt_o, mean_o, cov_o, d2 = _oracle(q, r, qm, rm, radius)
    # against the oracle: the port's gate is exact f32 subtract-first, so a
    # count can differ only for a pair within 1e-6 relative of r^2
    clear6 = _clear_of_gate(d2, radius, 1e-5)
    np.testing.assert_array_equal(cnt_t[clear6], cnt_o[clear6])
    # moments in f32 with coordinates of a few metres: 1e-4 absolute
    np.testing.assert_allclose(mean_t[clear6], mean_o[clear6], atol=1e-4)
    np.testing.assert_allclose(cov_t[clear6], cov_o[clear6], atol=2e-4)

    # the Pallas kernel in interpret mode: same subtract-first gate -> equal
    # counts; its moments go through a HIGHEST-precision matmul
    with pltpu.force_tpu_interpret_mode():
        cnt_p, mean_p, cov_p, ov_p = jpca._radius_pca_sweep(
            jnp.asarray(q), jnp.asarray(r), jnp.asarray(qm), jnp.asarray(rm),
            max_radius=radius, q_tile=256, W=700, use_pallas=True)
    assert int(ov_p) == 0
    np.testing.assert_array_equal(cnt_t, np.asarray(cnt_p))
    # the raw (uncentered here) sweep vs the port's centered one: 1e-4
    np.testing.assert_allclose(mean_t, np.asarray(mean_p), atol=1e-4)
    np.testing.assert_allclose(cov_t, np.asarray(cov_p), atol=5e-4)

    cnt_x, mean_x, cov_x = jpca.radius_pca_xla(
        jnp.asarray(q), jnp.asarray(r), jnp.asarray(qm), jnp.asarray(rm),
        max_radius=radius)
    clear = _clear_of_gate(d2, radius)
    np.testing.assert_array_equal(cnt_t[clear], np.asarray(cnt_x)[clear])
    np.testing.assert_allclose(mean_t[clear], np.asarray(mean_x)[clear],
                               atol=1e-4)
    np.testing.assert_allclose(cov_t[clear], np.asarray(cov_x)[clear],
                               atol=5e-4)


@pytest.mark.parametrize("dim", [2, 3])
def test_self_neighbourhood_matches_reference(dim):
    rng = np.random.default_rng(40 + dim)
    pts = (rng.uniform(-6, 6, size=(900, dim))).astype(np.float32)
    mask = rng.random(900) > 0.2
    pt, mt = torch.from_numpy(pts), torch.from_numpy(mask)
    cnt_t, mean_t, cov_t, ov = tpca.radius_pca(pt, pt, mt, mt,
                                               max_radius=1.0, q_tile=128,
                                               W=900)
    assert int(ov) == 0
    # same tensors as query and ref -> the one-sort path; it must equal the
    # two-cloud path on copies
    cnt_2, mean_2, cov_2, _ = tpca.radius_pca(pt, pt.clone(), mt, mt.clone(),
                                              max_radius=1.0, q_tile=128,
                                              W=900)
    np.testing.assert_array_equal(cnt_t.numpy(), cnt_2.numpy())
    np.testing.assert_allclose(mean_t.numpy(), mean_2.numpy(), atol=1e-6)
    np.testing.assert_allclose(cov_t.numpy(), cov_2.numpy(), atol=1e-6)
    # the reference's public entry point (on the CPU: radius_pca_xla after
    # the same centring)
    pj, mj = jnp.asarray(pts), jnp.asarray(mask)
    cnt_j, mean_j, cov_j, _ = jpca.radius_pca(pj, pj, mj, mj, max_radius=1.0)
    _, _, _, d2 = _oracle(pts, pts, mask, mask, 1.0)
    clear = _clear_of_gate(d2, 1.0)
    np.testing.assert_array_equal(cnt_t.numpy()[clear],
                                  np.asarray(cnt_j)[clear])
    np.testing.assert_allclose(mean_t.numpy()[clear],
                               np.asarray(mean_j)[clear], atol=1e-4)
    np.testing.assert_allclose(cov_t.numpy()[clear],
                               np.asarray(cov_j)[clear], atol=2e-4)
    # masked-out queries report nothing
    assert (cnt_t.numpy()[~mask] == 0).all()
    assert (cov_t.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("dim", [2, 3])
def test_centring_far_from_origin(dim):
    """Clouds kilometres from the origin: without the centring on the query
    mean, ``sxx/n - mean^2`` in f32 would be garbage (eps * |x|^2 ~ 1 m^2)."""
    rng = np.random.default_rng(60 + dim)
    base = np.array([5000.0, -3000.0, 800.0][:dim], np.float32)
    local = (rng.normal(size=(200, dim)) * 0.5).astype(np.float32)
    pts = base + local
    m = np.ones(200, bool)
    cnt_t, mean_t, cov_t, _ = _port(pts, pts, m, m, max_radius=1.0)
    cnt_o, mean_o, cov_o, d2 = _oracle(pts, pts, m, m, 1.0)
    clear = _clear_of_gate(d2, 1.0)
    np.testing.assert_array_equal(cnt_t[clear], cnt_o[clear])
    # the mean is restored to the original frame: f32 at 5 km resolves 5e-4
    np.testing.assert_allclose(mean_t[clear], mean_o[clear], atol=2e-3)
    np.testing.assert_allclose(cov_t[clear], cov_o[clear], atol=1e-4)
    cnt_j, mean_j, cov_j, _ = jpca.radius_pca(jnp.asarray(pts),
                                              jnp.asarray(pts),
                                              max_radius=1.0)
    np.testing.assert_allclose(cov_t[clear], np.asarray(cov_j)[clear],
                               atol=1e-4)


def test_overflow_count_matches_reference():
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(600, 3)).astype(np.float32)
    pts[:, 0] *= 0.01  # x collapsed -> every ref is a candidate of any tile
    m = np.ones(600, bool)
    _, _, _, ov_t = _port(pts, pts, m, m, max_radius=1.0, q_tile=128, W=256)
    _, _, _, ov_j = jpca._radius_pca_sweep(
        jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(m), jnp.asarray(m),
        max_radius=1.0, q_tile=128, W=256, use_pallas=False)
    assert ov_t > 0 and ov_t == int(ov_j)


def test_moment_helpers_match_reference():
    rng = np.random.default_rng(6)
    for dim in (2, 3):
        assert tpca._n_moments(dim) == jpca._n_moments(dim)
        x = rng.normal(size=(dim, 50)).astype(np.float32)
        np.testing.assert_array_equal(
            tpca._moment_rows(torch.from_numpy(x), dim).numpy(),
            np.asarray(jpca._moment_rows(jnp.asarray(x), dim)))
        acc = np.abs(rng.normal(size=(tpca._n_moments(dim), 40))
                     ).astype(np.float32) * 5
        acc[0] = np.round(acc[0])
        out_t = tpca._unpack_stats(torch.from_numpy(acc), dim)
        out_j = jpca._unpack_stats(jnp.asarray(acc), dim)
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    before = tpca.radius_pca.launches
    a = tpca.radius_pca(pts, pts, max_radius=0.8)
    b = tpca.radius_pca_plain(pts, pts, max_radius=0.8)
    assert tpca.radius_pca.launches == before
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
