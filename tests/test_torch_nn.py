"""Port parity: ``ops/nn.py`` (brute-force k-NN) against the JAX package's
XLA path and its Pallas kernel in interpret mode (CPU).

The port ranks by the subtract-first distance ``sum((r - q)^2)``; both
reference engines rank by the expanded form ``|q|^2 + |r|^2 - 2 q.r``, whose
rounding error grows as ``eps * |x|^2``.  Distances are therefore compared
with ``atol = 4 * eps * (|q|^2 + max |r|^2)`` per query, and indices only
where the gap to the neighbouring distances exceeds twice that: a closer
pair may rank either way in the reference.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu.ops import nn as jnn
from norlab_icp_mapper_tpu_torch.ops import nn as tnn
from norlab_icp_mapper_tpu_torch.ops import nn_sweep

EPS = float(np.finfo(np.float32).eps)


def knn_pallas_interp(*args, **kw):
    """The Pallas kernel in interpreter mode, as the reference's own tests
    run it on the CPU."""
    from jax.experimental.pallas import tpu as pltpu
    from norlab_icp_mapper_tpu.ops import nn_pallas
    with pltpu.force_tpu_interpret_mode():
        return nn_pallas.knn_pallas(*args, **kw)


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _j(x):
    return None if x is None else jnp.asarray(x)


def _port(q, r, qm, rm, k, **kw):
    d, i = tnn.knn(_t(q), _t(r), _t(qm), _t(rm), k=k, **kw)
    return d.numpy(), i.numpy()


def _assert_close_to_reference(q, r, qm, rm, k, d_ref, i_ref):
    """The port's result against a reference engine's, with the tolerance
    of the module docstring."""
    d_ref, i_ref = np.asarray(d_ref), np.asarray(i_ref)
    # one neighbour more than asked, to know the gap after the k-th
    d_t, i_t = _port(q, r, qm, rm, k + 1)
    d_k, i_k = d_t[:, :k], i_t[:, :k]
    d_same, i_same = _port(q, r, qm, rm, k)
    np.testing.assert_array_equal(d_same, d_k)  # k+1 search, same first k
    np.testing.assert_array_equal(i_same, i_k)
    np.testing.assert_array_equal(np.isfinite(d_k), np.isfinite(d_ref))
    np.testing.assert_array_equal(i_k >= 0, i_ref >= 0)
    np.testing.assert_array_equal(i_k >= 0, np.isfinite(d_k))
    r_valid = r if rm is None else r[rm]
    r2max = float((r_valid ** 2).sum(1).max()) if len(r_valid) else 0.0
    atol = 4 * EPS * ((q ** 2).sum(1) + r2max)[:, None] + 1e-12
    fin = np.isfinite(d_k)
    big = np.float32(3e38)
    assert (np.abs(np.where(fin, d_k, big) - np.where(fin, d_ref, big))
            <= atol).all()
    # rows ascending
    assert (np.diff(np.where(fin, d_k, big), axis=1) >= 0).all()
    # indices where the neighbouring distances are further than 2*atol away
    with np.errstate(invalid="ignore"):  # inf - inf in the empty tails
        prev_gap = np.concatenate([np.full((len(q), 1), np.inf),
                                   np.diff(d_k, axis=1)], axis=1)
        next_gap = np.diff(d_t, axis=1)
        clear = fin & (prev_gap > 2 * atol) & ~(next_gap <= 2 * atol)
    assert clear.mean() > 0.5  # the comparison really covers the indices
    np.testing.assert_array_equal(i_k[clear], i_ref[clear])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k", [1, 4, 10])
def test_plain_matches_xla_and_pallas(rng, k, dim):
    """Ragged N and M (multiples of no tile), both masks."""
    q = (rng.normal(size=(300, dim)) * 5).astype(np.float32)
    r = (rng.normal(size=(700, dim)) * 5).astype(np.float32)
    qm = rng.random(300) > 0.2
    rm = rng.random(700) > 0.3
    d_x, i_x = jnn._knn_xla(_j(q), _j(r), _j(qm), _j(rm), k=k, ref_tile=256)
    _assert_close_to_reference(q, r, qm, rm, k, d_x, i_x)
    d_p, i_p = knn_pallas_interp(_j(q), _j(r), _j(qm), _j(rm), k=k, tq=256,
                                 tr=256)
    _assert_close_to_reference(q, r, qm, rm, k, d_p, i_p)
    # invalid queries come back empty
    d_t, i_t = _port(q, r, qm, rm, k)
    assert np.isinf(d_t[~qm]).all() and (i_t[~qm] == -1).all()
    # a returned neighbour is a valid reference
    assert rm[i_t[i_t >= 0]].all()


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_max_radius_and_no_masks(rng, engine):
    q = (rng.normal(size=(130, 3)) * 3).astype(np.float32)
    r = (rng.normal(size=(257, 3)) * 3).astype(np.float32)
    radius = 0.9
    if engine == "xla":
        d_j, i_j = jnn._knn_xla(_j(q), _j(r), k=4, max_radius=radius)
    else:
        d_j, i_j = knn_pallas_interp(_j(q), _j(r), k=4, max_radius=radius,
                                     tq=256, tr=256)
    d_t, i_t = _port(q, r, None, None, 4, max_radius=radius)
    d_j, i_j = np.asarray(d_j), np.asarray(i_j)
    # a pair within rounding of r^2 may fall on either side of the gate
    near_gate = np.abs(np.where(np.isfinite(d_t), d_t, d_j)
                       - radius ** 2) < 1e-4
    same = (np.isfinite(d_t) == np.isfinite(d_j)) | near_gate
    assert same.all()
    both = np.isfinite(d_t) & np.isfinite(d_j)
    assert 0.05 < both.mean() < 0.95  # the radius cuts, but not everything
    np.testing.assert_allclose(d_t[both], d_j[both], atol=4 * EPS * 200)
    assert (d_t[np.isfinite(d_t)] <= np.float32(radius) ** 2).all()
    assert ((i_t >= 0) == np.isfinite(d_t)).all()


@pytest.mark.parametrize("n_valid_ref", [0, 3])
def test_fewer_than_k_valid_references(rng, n_valid_ref):
    """The tail of a row stays inf / -1 (SurfaceNormal's k-NN engine weights
    by ``idx >= 0``); with no valid reference the whole row does."""
    q = rng.normal(size=(50, 3)).astype(np.float32)
    r = rng.normal(size=(40, 3)).astype(np.float32)
    rm = np.zeros(40, bool)
    rm[[5, 17, 33][:n_valid_ref]] = True
    d_j, i_j = jnn._knn_xla(_j(q), _j(r), None, _j(rm), k=5)
    d_t, i_t = _port(q, r, None, rm, 5)
    np.testing.assert_array_equal(np.isfinite(d_t), np.isfinite(np.asarray(d_j)))
    assert np.isfinite(d_t[:, :n_valid_ref]).all()
    assert np.isinf(d_t[:, n_valid_ref:]).all()
    assert (i_t[:, n_valid_ref:] == -1).all()
    if n_valid_ref:
        assert set(np.unique(i_t[:, :n_valid_ref])) == {5, 17, 33}
        np.testing.assert_allclose(d_t[:, :3], np.asarray(d_j)[:, :3],
                                   atol=1e-5)
    # no reference at all
    d0, i0 = tnn.knn(_t(q), torch.zeros((0, 3)), k=2)
    assert d0.shape == (50, 2) and bool(torch.isinf(d0).all())
    assert bool((i0 == -1).all())
    # no query at all
    d1, i1 = tnn.knn(torch.zeros((0, 3)), _t(r), k=2)
    assert d1.shape == (0, 2) and i1.shape == (0, 2)


def test_ties_go_to_the_lower_index(rng):
    """The port's tie rule, pinned on exact ties.  (The reference's two
    engines disagree with each other for k > 1: the Pallas kernel puts the
    new tile before the running best, the XLA path the other way round.)  A
    cloud searched against itself with every point stored twice: each query
    finds itself and its twin at d2 = 0, lower index first, then pairs of
    equal distances, again lower index first."""
    base = rng.normal(size=(64, 3)).astype(np.float32)
    pts = np.concatenate([base, base])  # point i and i + 64 coincide
    d, i = _port(pts, pts, None, None, 4)
    own = np.arange(128) % 64
    np.testing.assert_array_equal(d[:, :2], 0.0)
    np.testing.assert_array_equal(i[:, 0], own)
    np.testing.assert_array_equal(i[:, 1], own + 64)
    np.testing.assert_array_equal(d[:, 2], d[:, 3])
    np.testing.assert_array_equal(i[:, 3], i[:, 2] + 64)
    # the same with a reference tile that splits the twins, and a reference
    # mask that removes some first twins: the survivor is found
    rm = np.ones(128, bool)
    rm[:10] = False
    d2_, i2_ = tnn.knn_plain(_t(pts), _t(pts), None, _t(rm), k=2, ref_tile=48)
    d2_, i2_ = d2_.numpy(), i2_.numpy()
    np.testing.assert_array_equal(i2_[:10, 0], np.arange(10) + 64)
    np.testing.assert_array_equal(i2_[10:64, 0], np.arange(10, 64))
    np.testing.assert_array_equal(d2_[:, 0], 0.0)


def test_subtract_first_is_exact_where_the_expanded_form_is_not(rng):
    """At coordinates of 60 m the reference's expanded form carries an error
    of about ``eps * |x|^2`` ~ 1e-3 m^2 -- more than the squared distance of
    a centimetre-scale neighbour -- while the port's subtract-first distance
    is good to a few ulps of d2.  Both stay inside the stated tolerance."""
    centre = np.array([60.0, -60.0, 60.0])
    r = (centre + rng.uniform(-0.5, 0.5, size=(400, 3))).astype(np.float32)
    q = (r[:150] + rng.normal(scale=0.01, size=(150, 3))).astype(np.float32)
    d_t, i_t = _port(q, r, None, None, 1)
    d_x, i_x = jnn._knn_xla(_j(q), _j(r), k=1)
    d_x, i_x = np.asarray(d_x), np.asarray(i_x)
    truth = ((q.astype(np.float64)[:, None] - r.astype(np.float64)[None]) ** 2
             ).sum(-1)
    d_true = truth.min(1)
    err_t = np.abs(d_t[:, 0] - d_true)
    err_x = np.abs(d_x[:, 0] - d_true)
    assert err_t.max() < 1e-9  # ulps of d2 ~ 3e-4
    assert err_x.max() > 1e-5  # eps * |x|^2 = 1.2e-7 * 10,800
    assert err_x.max() > 100 * err_t.max()
    atol = 4 * EPS * ((q ** 2).sum(1) + (r ** 2).sum(1).max())
    assert (np.abs(d_t[:, 0] - d_x[:, 0]) <= atol).all()
    # the port finds the true nearest neighbour for every query
    np.testing.assert_array_equal(i_t[:, 0], truth.argmin(1))


def test_plain_chunking_changes_nothing(rng, monkeypatch):
    q = rng.normal(size=(301, 2)).astype(np.float32)
    r = rng.normal(size=(517, 2)).astype(np.float32)
    qm, rm = rng.random(301) > 0.1, rng.random(517) > 0.1
    d0, i0 = tnn.knn_plain(_t(q), _t(r), _t(qm), _t(rm), k=6)
    monkeypatch.setattr(tnn, "_PLAIN_Q_CHUNK", 64)
    d1, i1 = tnn.knn_plain(_t(q), _t(r), _t(qm), _t(rm), k=6, ref_tile=50)
    np.testing.assert_array_equal(d0.numpy(), d1.numpy())
    np.testing.assert_array_equal(i0.numpy(), i1.numpy())
    assert i0.dtype == torch.int64 and d0.dtype == torch.float32


def test_pack_refs_keeps_order_and_counts(rng):
    r = _t(rng.normal(size=(37, 3)).astype(np.float32))
    rm = _t(rng.random(37) > 0.4)
    pack = tnn.pack_refs(r, rm)
    n = int(rm.sum())
    assert int(pack.n_valid) == n and pack.n_valid.dtype == torch.int64
    assert pack.ids.dtype == torch.int32
    np.testing.assert_array_equal(pack.ids[:n].numpy(),
                                  np.nonzero(rm.numpy())[0])
    np.testing.assert_array_equal(pack.ref_c[:n].numpy(), r.numpy()[rm.numpy()])
    whole = tnn.pack_refs(r, None)
    assert int(whole.n_valid) == 37
    np.testing.assert_array_equal(whole.ids.numpy(), np.arange(37))


def test_wrappers_on_the_cpu_launch_nothing(rng):
    q = _t(rng.normal(size=(90, 3)).astype(np.float32))
    r = _t(rng.normal(size=(200, 3)).astype(np.float32))
    before = (tnn.knn.launches, dict(tnn.knn.launches_by_shape))
    d, i = tnn.knn(q, r, k=3)
    d1, i1 = tnn.nn1(q, r)
    assert (tnn.knn.launches, tnn.knn.launches_by_shape) == before
    assert d1.shape == (90,) and i1.shape == (90,)
    np.testing.assert_array_equal(d1.numpy(), d[:, 0].numpy())
    np.testing.assert_array_equal(i1.numpy(), i[:, 0].numpy())
    # radius_knn: without a radius the brute-force search, with one the sweep
    d2, i2, ov2 = tnn.radius_knn(q, r, k=3)
    assert ov2.ndim == 0 and int(ov2) == 0
    np.testing.assert_array_equal(i2.numpy(), i.numpy())
    d3, i3, ov3 = tnn.radius_knn(q, r, k=3, max_radius=1.0, q_tile=128,
                                 W=200)
    ds, is_, ov = nn_sweep.sweep_knn(q, r, k=3, max_radius=1.0, q_tile=128,
                                     W=200)
    np.testing.assert_array_equal(i3.numpy(), is_.numpy())
    assert int(ov3) == int(ov) == 0
    # inside the radius the sweep and the brute-force search agree
    hit = i3 >= 0
    np.testing.assert_array_equal(i3[hit].numpy(), i[hit].numpy())


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    q = torch.zeros(8, 3)
    with pytest.raises(ValueError, match="1 <= k <= 32"):
        tnn.knn(q, q, k=33)
    with pytest.raises(ValueError, match="1 <= k <= 32"):
        tnn.knn(q, q, k=0)
    pack = tnn.pack_refs(q, None)
    # a CPU tensor never reaches a launch: the checks come first
    with pytest.raises(ValueError, match="CUDA tensors"):
        tnn._knn_kernel(q, None, pack, 1)
    with pytest.raises(ValueError, match="D in"):
        tnn._knn_kernel(torch.zeros(8, 4), None, pack, 1)
    with pytest.raises(ValueError, match="float32"):
        tnn._knn_kernel(q.double(), None, pack, 1)
    with pytest.raises(ValueError, match="differ in D"):
        tnn._knn_kernel(torch.zeros(8, 2), None, pack, 1)
    with pytest.raises(ValueError, match="int64 count"):
        tnn._knn_kernel(q, None, pack._replace(n_valid=pack.n_valid.int()), 1)
    with pytest.raises(ValueError, match="query rows"):
        tnn._knn_kernel(q, (torch.zeros(8, dtype=torch.int64),
                            torch.tensor(8)), pack, 1)
    with pytest.raises(ValueError, match="own cloud"):
        tnn._knn_kernel(torch.zeros(9, 3), None, pack, 1, self_search=True)
