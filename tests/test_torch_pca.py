"""Port parity: ``ops/pca.py`` (it holds a kernel).

On the CPU the port's ``radius_pca`` runs its kernel's plain PyTorch version:
per-query centred moments, the kernel's epilogue in tensor operations, rows
scattered to the queries' original index.  It is held against the JAX sweep
with the Pallas kernel under ``force_tpu_interpret_mode``, against
``radius_pca_xla``, and against a float64 numpy oracle; the normals sibling
against the JAX ``SurfaceNormalDataPointsFilter``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from norlab_icp_mapper_tpu import PointBatch as JBatch
from norlab_icp_mapper_tpu.filters import core as jf
from norlab_icp_mapper_tpu.ops import pca as jpca
from norlab_icp_mapper_tpu_torch.ops import nn_sweep as tsweep, pca as tpca


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


@pytest.mark.parametrize("dim", [2, 3])
def test_centring_far_from_origin_wide_cloud(dim):
    """A thin surface spanning 60 m, 500 m from the origin.  Centring on the
    centroid leaves |x| of up to 30 m, so the reference's raw-moment
    covariance carries eps * |x|^2 ~ 1e-4 m^2 of noise, as much as the
    surface's own 1 cm^2 of thickness.  The port sums d = x - q (|d| <= r)
    and is held to the float64 oracle at 1e-6 m^2, which the reference
    cannot meet."""
    rng = np.random.default_rng(80 + dim)
    n = 1500
    cols = [rng.uniform(-30, 30, n)]
    if dim == 3:
        cols.append(rng.uniform(-1.5, 1.5, n))
    cols.append(rng.normal(scale=0.01, size=n))
    pts = (np.array([500.0, -500.0, 500.0][:dim])
           + np.column_stack(cols)).astype(np.float32)
    m = np.ones(n, bool)
    cnt_t, mean_t, cov_t, ov = _port(pts, pts, m, m, max_radius=1.0,
                                     q_tile=256, W=n)
    assert ov == 0
    cnt_o, mean_o, cov_o, d2 = _oracle(pts, pts, m, m, 1.0)
    # at 500 m an f32 coordinate resolves 3e-5 m: pairs within 1e-4 of r^2
    clear = _clear_of_gate(d2, 1.0, 1e-4)
    assert clear.mean() > 0.95
    np.testing.assert_array_equal(cnt_t[clear], cnt_o[clear])
    np.testing.assert_allclose(mean_t[clear], mean_o[clear], atol=1e-4)
    np.testing.assert_allclose(cov_t[clear], cov_o[clear], atol=1e-6)
    _, _, cov_j, _ = jpca.radius_pca(jnp.asarray(pts), jnp.asarray(pts),
                                     max_radius=1.0)
    err_j = np.abs(np.asarray(cov_j) - cov_o)[clear].max()
    err_t = np.abs(cov_t - cov_o)[clear].max()
    assert err_j > 1e-5 > 10 * err_t
    # the smallest eigenvalue (the surface's thickness, 1e-4 m^2) survives
    ev_t = np.linalg.eigvalsh(cov_t[clear].astype(np.float64))[:, 0]
    ev_o = np.linalg.eigvalsh(cov_o[clear])[:, 0]
    np.testing.assert_allclose(ev_t, ev_o, atol=1e-6)


def _collapsed_cloud(n=600):
    rng = np.random.default_rng(5)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[:, 0] *= 0.01  # x collapsed -> every ref is a candidate of any tile
    return pts


def test_overflow_count_matches_reference():
    pts = _collapsed_cloud()
    m = np.ones(600, bool)
    _, _, _, ov_t = _port(pts, pts, m, m, max_radius=1.0, q_tile=128, W=256)
    _, _, _, ov_j = jpca._radius_pca_sweep(
        jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(m), jnp.asarray(m),
        max_radius=1.0, q_tile=128, W=256, use_pallas=False)
    assert ov_t > 0 and ov_t == int(ov_j)


@pytest.mark.parametrize("self_form", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_overflow_and_truncated_windows_match_reference(self_form, masked):
    """On a cloud that overflows, ``overflow`` equals the reference's count,
    and the statistics are those of the truncated windows
    ``[lo, min(hi, lo + W))``: the normals sibling reports the same count and
    overflow as ``radius_pca``, in the self form and on copies."""
    pts = _collapsed_cloud()
    m = (np.random.default_rng(9).random(600) > 0.3) if masked \
        else np.ones(600, bool)
    pt, mt = torch.from_numpy(pts), torch.from_numpy(m)
    other = (pt, mt) if self_form else (pt.clone(), mt.clone())
    kw = dict(max_radius=1.0, q_tile=128, W=256)
    cnt, _, _, ov = tpca.radius_pca(pt, other[0], mt, other[1], **kw)
    cnt_n, _, _, ov_n = tpca.radius_pca_normals(pt, other[0], mt, other[1],
                                                min_count=3, **kw)
    _, _, _, ov_j = jpca._radius_pca_sweep(
        jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(m), jnp.asarray(m),
        max_radius=1.0, q_tile=128, W=256, use_pallas=False)
    assert int(ov) > 0 and int(ov) == int(ov_n) == int(ov_j)
    np.testing.assert_array_equal(cnt.numpy(), cnt_n.numpy())
    # a truncated window holds at most W references
    assert float(cnt.max()) <= 256
    assert not cnt.numpy()[~m].any() and cnt.numpy()[m].sum() > 0


def _neighbourhoods(rng, n, dim, k, scale, offset):
    """``n`` queries near ``offset`` with ``k`` neighbours each within
    ``scale`` of them; float32."""
    q = (offset + rng.normal(size=(n, dim))).astype(np.float32)
    pts = (q[:, None, :] + rng.uniform(-scale, scale, size=(n, k, dim))
           ).astype(np.float32)
    return q, pts


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k,scale,offset", [(1, 1.0, 0.0), (7, 1.0, 0.0),
                                            (40, 0.3, 5.0), (40, 2.0, 30.0)])
def test_moment_helpers_match_reference(dim, k, scale, offset):
    """The kernel's epilogue (mean and covariance from the sums of
    ``d = x - q`` and ``d d^T``) against the reference's ``_unpack_stats``
    fed the raw moments of the same neighbourhoods, and against float64."""
    rng = np.random.default_rng(6 + dim + k)
    q, pts = _neighbourhoods(rng, 50, dim, k, scale, offset)
    # the reference: rows 1, x, xx (diagonal), then xy, xz, yz, summed per query
    rows = np.stack([np.asarray(jpca._moment_rows(jnp.asarray(p.T), dim))
                     .sum(axis=1) for p in pts], axis=1)
    cnt_j, mean_j, cov_j = jpca._unpack_stats(jnp.asarray(rows), dim)
    d = pts - q[:, None, :]
    sd = d.sum(1)
    pairs = [(a, a) for a in range(dim)] + \
        [(a, b) for a in range(dim) for b in range(a + 1, dim)]
    sdd = np.stack([(d[:, :, a] * d[:, :, b]).sum(1) for a, b in pairs], 1)
    cnt = np.full(50, float(k), np.float32)
    mean_t, cov_t = tpca._moments_epilogue(
        torch.from_numpy(cnt), torch.from_numpy(sd), torch.from_numpy(sdd),
        torch.from_numpy(q), torch.zeros(dim))
    p64 = pts.astype(np.float64)
    mean_o = p64.mean(1)
    dev = p64 - mean_o[:, None]
    cov_o = np.einsum("nkd,nke->nde", dev, dev) / k
    np.testing.assert_array_equal(np.asarray(cnt_j), cnt)
    # the port against float64: eps * scale^2 per term
    np.testing.assert_allclose(mean_t.numpy(), mean_o,
                               atol=4e-7 * (abs(offset) + 3 + scale))
    np.testing.assert_allclose(cov_t.numpy(), cov_o, atol=2e-6 * scale ** 2)
    # the reference cancels at |x|^2: eps * (|offset| + 3 + scale)^2
    mag = (abs(offset) + 3 + scale) ** 2
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j),
                               atol=4e-6 * mag)
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j),
                               atol=1e-6 * (abs(offset) + 3 + scale))
    assert np.allclose(cov_t.numpy(), np.swapaxes(cov_t.numpy(), 1, 2))
    # nothing in range: zeros, not the query
    z = torch.zeros(3)
    mean_0, cov_0 = tpca._moments_epilogue(z, torch.zeros(3, dim),
                                           torch.zeros(3, len(pairs)),
                                           torch.ones(3, dim), torch.ones(dim))
    assert not mean_0.any() and not cov_0.any()


@pytest.mark.parametrize("dim", [2, 3])
def test_results_land_on_original_rows_of_a_masked_unsorted_cloud(dim):
    """Queries in no order, a third masked out: every valid row holds the
    statistics of ITS point (held against the oracle row by row), every
    masked row is zero in all five outputs."""
    rng = np.random.default_rng(90 + dim)
    pts = rng.uniform(-5, 5, size=(700, dim)).astype(np.float32)
    mask = rng.random(700) > 0.33
    pt, mt = torch.from_numpy(pts), torch.from_numpy(mask)
    s = tpca._radius_pca(pt, pt, mt, mt, 1.2, 128, 700, 3, True)
    assert int(s.overflow) == 0
    cnt_o, mean_o, cov_o, d2 = _oracle(pts, pts, mask, mask, 1.2)
    clear = _clear_of_gate(d2, 1.2, 1e-5)
    np.testing.assert_array_equal(s.cnt.numpy()[clear], cnt_o[clear])
    np.testing.assert_allclose(s.mean.numpy()[clear], mean_o[clear],
                               atol=2e-6)
    np.testing.assert_allclose(s.cov.numpy()[clear], cov_o[clear], atol=2e-6)
    for x in (s.cnt, s.mean, s.cov, s.evals, s.normals):
        assert not x.numpy()[~mask].any()
    # a permutation of the rows permutes the results
    perm = rng.permutation(700)
    s2 = tpca._radius_pca(torch.from_numpy(pts[perm]),
                          torch.from_numpy(pts[perm].copy()),
                          torch.from_numpy(mask[perm]),
                          torch.from_numpy(mask[perm].copy()), 1.2, 128, 700,
                          3, True)
    np.testing.assert_array_equal(s2.cnt.numpy(), s.cnt.numpy()[perm])
    np.testing.assert_allclose(s2.cov.numpy(), s.cov.numpy()[perm],
                               atol=1e-6)


@pytest.mark.parametrize("dim", [2, 3])
def test_normals_sibling_against_the_reference_filter(dim):
    """``radius_pca_normals`` against the JAX SurfaceNormal filter with a
    finite ``maxDist``: normals up to sign where the two smallest eigenvalues
    are apart, eigenvalues, counts, and the degenerate rule (fewer than
    min(knn, 3) neighbours: a unit normal along the last axis)."""
    rng = np.random.default_rng(100 + dim)
    n = 800
    if dim == 3:
        pts = np.column_stack([rng.uniform(-4, 4, n), rng.uniform(-4, 4, n),
                               rng.normal(scale=0.01, size=n)])
    else:
        pts = np.column_stack([rng.uniform(-8, 8, n),
                               rng.normal(scale=0.01, size=n)])
    pts = pts.astype(np.float32)
    # an isolated point and an isolated pair: 1 and 2 neighbours
    pts[:3] = np.array([[30.0, 30.0, 30.0][:dim], [-30.0, 30.0, 5.0][:dim],
                        [-30.2, 30.1, 5.1][:dim]], np.float32)
    fj = jf.filter_registry.create(
        "SurfaceNormalDataPointsFilter",
        dict(knn=10, maxDist=1.0, keepEigenValues=1, keepDensities=1))
    oj = fj.apply(JBatch.from_numpy(pts))
    pt = torch.from_numpy(pts)
    cnt, evals, normals, ov = tpca.radius_pca_normals(
        pt, pt, None, None, max_radius=1.0, q_tile=256, W=n, min_count=3)
    assert int(ov) == 0
    nj = np.asarray(oj.descriptors["normals"])[:n]
    ej = np.asarray(oj.descriptors["eigValues"])[:n]
    fb = np.zeros(dim, np.float32)
    fb[-1] = 1
    np.testing.assert_array_equal(normals.numpy()[:3], np.tile(fb, (3, 1)))
    np.testing.assert_array_equal(nj[:3], np.tile(fb, (3, 1)))
    assert cnt.numpy()[:3].tolist() == [1.0, 2.0, 2.0]
    # without min_count the pair's normal is an eigenvector, not the rule's
    _, _, raw, _ = tpca.radius_pca_normals(pt, pt, None, None, max_radius=1.0,
                                           q_tile=256, W=n)
    assert abs(float(raw[1] @ torch.from_numpy(fb))) < 0.99
    np.testing.assert_allclose(np.linalg.norm(normals.numpy(), axis=1), 1.0,
                               atol=1e-5)
    # the reference's CPU engine gates on the expanded-form distance, so a
    # neighbour within rounding of the radius may be counted differently
    dens = np.asarray(oj.descriptors["densities"])[:n, 0]
    vol = 4.0 / 3.0 * np.pi if dim == 3 else np.pi
    assert (np.abs(cnt.numpy() - dens * vol) <= 1.01).all()
    same = np.abs(cnt.numpy() - dens * vol) < 0.5
    np.testing.assert_allclose(evals.numpy()[same], ej[same], atol=2e-4)
    gap = (ej[:, 1] - ej[:, 0] > 1e-3) & same
    gap[:3] = False
    assert gap.mean() > 0.9
    cos = np.abs(np.sum(nj * normals.numpy(), axis=1))
    assert (cos[gap] > 1 - 1e-4).all()


def _block_windows(qp, rp, r, q_tile, W, block):
    """The windows as a block of the kernel finds them, in plain tensor
    operations: per block of ``block`` sorted valid queries its first and
    last packed x, the bounds of its tile and of the block by
    ``searchsorted`` over the valid references' x, ``(start, end, queries,
    overflow)``."""
    n_q, m = int(qp.n_valid), int(rp.n_valid)
    dev = qp.ref_s.device
    W = min(W, rp.ref_s.shape[0])
    first = torch.arange(0, n_q, block, device=dev)
    last = torch.clamp(first + block, max=n_q) - 1
    t_first = (first // q_tile) * q_tile
    t_last = torch.clamp(t_first + q_tile, max=n_q) - 1
    qx, rx = qp.ref_s[:n_q, 0], rp.ref_s[:m, 0].contiguous()
    rt = torch.tensor(r, dtype=torch.float32, device=dev)
    lo = torch.searchsorted(rx, qx[t_first] - rt)
    hi = torch.searchsorted(rx, qx[t_last] + rt)
    overflow = ((hi - lo > W) & (first % q_tile == 0)).sum()
    t_end = torch.minimum(hi, lo + W)
    start = torch.maximum(torch.searchsorted(rx, qx[first] - rt), lo)
    end = torch.minimum(torch.searchsorted(rx, qx[last] + rt, right=True),
                        t_end)
    return start, torch.maximum(end, start), last - first + 1, overflow


def test_block_windows_match_the_wrapper_windows():
    """The windows as a kernel block finds them (first and last packed x of
    the block and of its tile, bounds over the valid references) equal the
    wrapper's ``sweep_windows`` on the padded arrays, overflow included."""
    rng = np.random.default_rng(11)
    pts = rng.uniform(-3, 3, size=(1000, 3)).astype(np.float32)
    pts[:, 0] *= 0.2
    mask = rng.random(1000) > 0.25
    pack = tsweep.presort_ref(torch.from_numpy(pts), torch.from_numpy(mask))
    for q_tile, W, block in ((256, 300, 128), (512, 1000, 256),
                             (256, 150, 256)):
        start, end, nq, ov = _block_windows(pack, pack, 0.4, q_tile, W,
                                            block)
        pad = -(-1000 // q_tile) * q_tile - 1000
        qx = tsweep.pad_rows(pack.ref_xs, pad, tsweep.BIG)
        qm = tsweep.pad_rows(pack.ref_mask_s, pad, False)
        _, _, live, ov_w, b_start, b_end = tsweep.sweep_windows(
            qx, qm, pack, torch.tensor(0.4), q_tile, W, block)
        k = start.shape[0]  # blocks that hold a valid query
        assert k == -(-int(mask.sum()) // block)
        np.testing.assert_array_equal(start.numpy(), b_start.numpy()[:k])
        np.testing.assert_array_equal(end.numpy(), b_end.numpy()[:k])
        assert int(nq.sum()) == int(mask.sum())
        assert int(ov) == int(ov_w)
        assert (W < 1000) == (int(ov) > 0)


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    rng = np.random.default_rng(7)
    pts = torch.from_numpy(rng.normal(size=(300, 3)).astype(np.float32))
    before = tpca.radius_pca.launches
    a = tpca.radius_pca(pts, pts, max_radius=0.8)
    b = tpca.radius_pca_plain(pts, pts, max_radius=0.8)
    c = tpca.radius_pca_normals(pts, pts, max_radius=0.8, min_count=3)
    d = tpca.radius_pca_normals_plain(pts, pts, max_radius=0.8, min_count=3)
    assert tpca.radius_pca.launches == before
    for x, y in zip(a + c, b + d):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
