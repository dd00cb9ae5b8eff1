"""Port parity: ``ops/nn_sweep.py`` (it holds a kernel).

On the CPU the port's ``sweep_knn`` runs its kernel's plain PyTorch version.
It is held against the JAX function run as the JAX package's own tests run
it on the CPU -- the Pallas kernel under ``force_tpu_interpret_mode`` and the
XLA window path -- and against a brute-force numpy oracle.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from norlab_icp_mapper_tpu.ops import nn_sweep as js
from norlab_icp_mapper_tpu_torch.ops import nn_sweep as ts


def _clouds(seed, n, m, dim, extent=6.0, masks=True):
    rng = np.random.default_rng(seed)
    q = rng.uniform(-extent, extent, size=(n, dim)).astype(np.float32)
    r = rng.uniform(-extent, extent, size=(m, dim)).astype(np.float32)
    if masks:
        qm = rng.random(n) > 0.15
        rm = rng.random(m) > 0.15
    else:
        qm, rm = np.ones(n, bool), np.ones(m, bool)
    return q, r, qm, rm


def _oracle(q, r, qm, rm, k, radius):
    """Brute force in float64 on the f32 inputs."""
    d2 = ((q[:, None, :].astype(np.float64) - r[None].astype(np.float64))
          ** 2).sum(-1)
    d2[:, ~rm] = np.inf
    d2[d2 > radius * radius] = np.inf
    idx = np.argsort(d2, axis=1, kind="stable")[:, :k]
    d = np.take_along_axis(d2, idx, axis=1)
    idx = np.where(np.isfinite(d), idx, -1)
    d[~qm] = np.inf
    idx[~qm] = -1
    return d, idx


def _port(q, r, qm, rm, **kw):
    d, i, ov = ts.sweep_knn(torch.from_numpy(q), torch.from_numpy(r),
                            torch.from_numpy(qm), torch.from_numpy(rm), **kw)
    return d.numpy(), i.numpy(), int(ov)


def _jax(q, r, qm, rm, use_pallas, **kw):
    if use_pallas:
        with pltpu.force_tpu_interpret_mode():
            d, i, ov = js.sweep_knn(jnp.asarray(q), jnp.asarray(r),
                                    jnp.asarray(qm), jnp.asarray(rm),
                                    use_pallas=True, **kw)
    else:
        d, i, ov = js.sweep_knn(jnp.asarray(q), jnp.asarray(r),
                                jnp.asarray(qm), jnp.asarray(rm),
                                use_pallas=False, **kw)
    return np.asarray(d), np.asarray(i), int(ov)


def _assert_same(d_a, i_a, d_b, i_b, q, r, rtol=1e-6, atol=0.0):
    """Distances equal to ``rtol``; validity patterns equal; indices equal
    except where two candidates tie (then the distance each index implies is
    the reported one)."""
    assert (np.isfinite(d_a) == np.isfinite(d_b)).all()
    fin = np.isfinite(d_a)
    np.testing.assert_allclose(d_a[fin], d_b[fin], rtol=rtol, atol=atol)
    assert ((i_a >= 0) == fin).all() and ((i_b >= 0) == fin).all()
    diff = fin & (i_a != i_b)
    for row, col in zip(*np.nonzero(diff)):
        for i_x in (i_a, i_b):
            implied = np.sum((q[row].astype(np.float64)
                              - r[i_x[row, col]].astype(np.float64)) ** 2)
            assert abs(implied - d_a[row, col]) <= 1e-5 * max(implied, 1e-3)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k", [1, 3, 6])
def test_matches_oracle_and_jax_paths(dim, k):
    """Unpacked reference paths compute exact f32 subtract-first distances
    (Pallas) or the expanded form (XLA window path); the port computes
    subtract-first.  1e-6 relative for the former; for the latter 1e-4
    relative plus 5e-5 absolute, because ``|q|^2 + |r|^2 - 2 q.r`` cancels:
    its error is a few eps of |x|^2 ~ 100 m^2, whatever the distance."""
    q, r, qm, rm = _clouds(10 + dim + k, 700, 1500, dim)
    kw = dict(k=k, max_radius=1.5, q_tile=256, W=1024)
    d_t, i_t, ov_t = _port(q, r, qm, rm, **kw)
    assert ov_t == 0
    d_o, i_o = _oracle(q, r, qm, rm, k, 1.5)
    # f32 coordinates of a few metres: each difference carries ~5e-7 of
    # absolute rounding, which dominates the smallest distances
    _assert_same(d_t, i_t, d_o, i_o, q, r, rtol=2e-6, atol=1e-6)

    d_p, i_p, ov_p = _jax(q, r, qm, rm, True, packed=False, **kw)
    assert ov_p == ov_t
    _assert_same(d_t, i_t, d_p, i_p, q, r, rtol=1e-6, atol=2e-7)

    d_x, i_x, ov_x = _jax(q, r, qm, rm, False, **kw)
    assert ov_x == ov_t
    # pairs within the expanded form's rounding of r^2 may flip: compare
    # where the oracle is clear of the gate
    clear = np.abs(d_o - 1.5 ** 2) > 1e-3
    ok = clear.all(axis=1)
    _assert_same(d_t[ok], i_t[ok], d_x[ok], i_x[ok], q[ok], r, rtol=1e-4,
                 atol=5e-5)


@pytest.mark.parametrize("k", [3, 6])
def test_exact_k_versus_packed_keys(k):
    """The deliberate difference from the TPU default: for k > 1 the port
    returns exact distances under ``d2 <= r^2``; the reference's packed
    path returns distances quantised to r^2/2^17 and drops pairs in the last
    quantisation step below r^2.  Equal up to one step; ties within a step
    may swap."""
    radius = 1.5
    step = radius * radius / (2 ** 17 - 1)
    q, r, qm, rm = _clouds(30 + k, 600, 1200, 3)
    kw = dict(k=k, max_radius=radius, q_tile=256, W=1024)
    d_t, i_t, _ = _port(q, r, qm, rm, **kw)
    d_p, i_p, _ = _jax(q, r, qm, rm, True, packed=True, **kw)
    both = np.isfinite(d_t) & np.isfinite(d_p)
    # validity differs only for exact distances within a step of r^2
    only_t = np.isfinite(d_t) & ~np.isfinite(d_p)
    assert (d_t[only_t] >= radius * radius - 2 * step).all()
    assert not (np.isfinite(d_p) & ~np.isfinite(d_t)).any()
    # one step, plus the f32 rounding of ``qd * step`` at d2 ~ 2
    assert (np.abs(d_t[both] - d_p[both]) <= step + 1e-6).all()
    swapped = both & (i_t != i_p)
    for row, col in zip(*np.nonzero(swapped)):
        # a swap is a tie within one step: the packed pick's exact distance
        # lies within a step of the port's
        exact = np.sum((q[row] - r[i_p[row, col]]) ** 2)
        assert abs(exact - d_t[row, col]) <= 2 * step
    assert swapped.mean() < 0.01


@pytest.mark.parametrize("dim", [2, 3])
def test_presorted_and_assume_sorted(dim):
    q, r, qm, rm = _clouds(50 + dim, 500, 2000, dim)
    kw = dict(k=3, max_radius=1.2, q_tile=128, W=512)
    d0, i0, o0 = _port(q, r, qm, rm, **kw)
    qt, rt, qmt, rmt = map(torch.from_numpy, (q, r, qm, rm))
    pack = ts.presort_ref(rt, rmt)
    pq = ts.presort_queries(qt - pack.center, qmt)
    d1, i1, o1 = ts.sweep_knn(qt, rt, qmt, rmt, presorted=pack,
                              presorted_q=pq, **kw)
    np.testing.assert_array_equal(i1.numpy(), i0)
    np.testing.assert_array_equal(d1.numpy(), d0)
    assert int(o1) == o0
    # assume_sorted: queries already in sweep order, results in that order
    order = np.argsort(np.where(qm, q[:, 0], 1e9), kind="stable")
    d2, i2, o2 = ts.sweep_knn(qt[order], rt, qmt[order], rmt, presorted=pack,
                              assume_sorted=True, **kw)
    np.testing.assert_array_equal(i2.numpy(), i0[order])
    np.testing.assert_array_equal(d2.numpy(), d0[order])
    # and the reference agrees on the assume_sorted form
    pj = js.presort_ref(jnp.asarray(r), jnp.asarray(rm))
    dj, ij, oj = js.sweep_knn(jnp.asarray(q[order]), jnp.asarray(r),
                              jnp.asarray(qm[order]), jnp.asarray(rm),
                              use_pallas=False, presorted=pj,
                              assume_sorted=True, **kw)
    fin = np.isfinite(d2.numpy())
    assert (np.isfinite(np.asarray(dj)) == fin).mean() > 0.999
    assert (np.asarray(ij) == i2.numpy()).mean() > 0.999


def test_presort_pack_matches_reference():
    q, r, qm, rm = _clouds(60, 10, 900, 3)
    pj = js.presort_ref(jnp.asarray(r), jnp.asarray(rm))
    pt = ts.presort_ref(torch.from_numpy(r), torch.from_numpy(rm))
    n_valid = int(rm.sum())
    assert int(pt.n_valid) == n_valid
    # centroid: one f32 sum over 900 rows, order may differ
    np.testing.assert_allclose(pt.center.numpy(), np.asarray(pj[5]),
                               atol=1e-5)
    np.testing.assert_array_equal(pt.ref_order.numpy()[:n_valid],
                                  np.asarray(pj[3])[:n_valid])
    np.testing.assert_array_equal(pt.ref_mask_s.numpy(), np.asarray(pj[1]))
    np.testing.assert_allclose(pt.ref_xs.numpy(), np.asarray(pj[2]),
                               atol=1e-5)


def test_overflow_count_equal_and_neighbours_radius_verified():
    """x collapsed: every ref is a candidate of every tile, span >> W.  The
    count of overflowing tiles equals the reference's; results are not
    defined there, but every returned neighbour lies within the radius."""
    rng = np.random.default_rng(3)
    pts = rng.normal(size=(600, 3)).astype(np.float32)
    pts[:, 0] *= 0.001
    m = np.ones(600, bool)
    kw = dict(k=1, max_radius=1.0, q_tile=128, W=256)
    d_t, i_t, ov_t = _port(pts, pts, m, m, **kw)
    _, _, ov_x = _jax(pts, pts, m, m, False, **kw)
    _, _, ov_p = _jax(pts, pts, m, m, True, **kw)
    assert ov_t > 0 and ov_t == ov_x == ov_p
    hit = i_t[:, 0] >= 0
    implied = ((pts[hit] - pts[i_t[hit, 0]]) ** 2).sum(-1)
    assert (implied <= 1.0 + 1e-6).all()
    np.testing.assert_allclose(d_t[hit, 0], implied, atol=1e-6)


def test_empty_and_all_invalid_reference():
    q = np.random.default_rng(0).normal(size=(100, 3)).astype(np.float32)
    qm = np.ones(100, bool)
    d, i, ov = _port(q, np.zeros((0, 3), np.float32), qm, np.zeros(0, bool),
                     k=2, max_radius=1.0, q_tile=128, W=256)
    assert np.isinf(d).all() and (i == -1).all() and ov == 0
    r = q.copy()
    d, i, ov = _port(q, r, qm, np.zeros(100, bool), k=1, max_radius=1.0,
                     q_tile=128, W=256)
    assert np.isinf(d).all() and (i == -1).all()
    # all-invalid queries: no live tile
    d, i, ov = _port(q, r, np.zeros(100, bool), qm, k=1, max_radius=1.0,
                     q_tile=128, W=256)
    assert np.isinf(d).all() and (i == -1).all() and ov == 0


def test_ties_resolve_to_lowest_sorted_index():
    # two refs at the same distance from the query, same x: the one that
    # sorts first (stable sort keeps input order) wins, as argmin does
    q = np.array([[0.0, 0.0, 0.0]], np.float32)
    r = np.array([[0.5, 0.5, 0.0], [0.5, -0.5, 0.0], [0.5, 0.0, 0.5]],
                 np.float32)
    d, i, _ = _port(q, r, np.ones(1, bool), np.ones(3, bool), k=3,
                    max_radius=2.0, q_tile=128, W=256)
    np.testing.assert_array_equal(i[0], [0, 1, 2])
    np.testing.assert_allclose(d[0], [0.5, 0.5, 0.5])


def test_cpu_tensor_takes_plain_path_and_counts_no_launch():
    q, r, qm, rm = _clouds(70, 300, 600, 3)
    before = ts.sweep_knn.launches
    d0, i0, _ = _port(q, r, qm, rm, k=2, max_radius=1.0, q_tile=128, W=512)
    d1, i1, _ = ts.sweep_knn_plain(
        torch.from_numpy(q), torch.from_numpy(r), torch.from_numpy(qm),
        torch.from_numpy(rm), k=2, max_radius=1.0, q_tile=128, W=512)
    assert ts.sweep_knn.launches == before
    np.testing.assert_array_equal(d0, d1.numpy())
    np.testing.assert_array_equal(i0, i1.numpy())


def test_block_windows_cover_tile_windows():
    """The kernel's 128-query blocks search the part of their tile's window
    their own queries can reach; the union must hold every candidate."""
    q, r, qm, rm = _clouds(80, 1000, 3000, 3, extent=10.0)
    rt, rmt = torch.from_numpy(r), torch.from_numpy(rm)
    pack = ts.presort_ref(rt, rmt)
    qc = torch.from_numpy(q) - pack.center
    order, _ = ts.presort_queries(qc, torch.from_numpy(qm))
    qs, qms = qc[order], torch.from_numpy(qm)[order]
    pad = 1024 - 1000
    qx = torch.where(qms, qs[:, 0], torch.full_like(qs[:, 0], ts.BIG))
    qx_s, qm_s = ts.pad_rows(qx, pad, ts.BIG), ts.pad_rows(qms, pad, False)
    radius = torch.tensor(1.5)
    lo, t_end, live, ov, b_start, b_end = ts.sweep_windows(
        qx_s, qm_s, pack, radius, 256, 3000, 128)
    assert int(ov) == 0 and b_start.shape[0] == 8
    xs = pack.ref_xs.numpy()
    for b in range(8):
        sl = slice(b * 128, (b + 1) * 128)
        v = qm_s[sl].numpy()
        if not v.any():
            assert int(b_end[b]) == int(b_start[b])
            continue
        x = qx_s[sl].numpy()[v]
        need = np.nonzero((xs >= x.min() - 1.5) & (xs <= x.max() + 1.5)
                          & (np.arange(len(xs)) < int(pack.n_valid)))[0]
        assert int(b_start[b]) <= need.min()
        assert int(b_end[b]) > need.max()
        assert int(b_start[b]) >= int(lo[b // 2])
        assert int(b_end[b]) <= int(t_end[b // 2])
