"""Port parity: closed-form eigen solvers and voxel selection against numpy
and the JAX package (CPU)."""
import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu.ops import eigen as je, voxel as jv
from norlab_icp_mapper_tpu_torch.ops import eigen as te, voxel as tv


def _sym(rng, n, d, scale=1.0):
    a = rng.normal(size=(n, d, d)).astype(np.float32) * scale
    return (a @ np.swapaxes(a, 1, 2)).astype(np.float32)


@pytest.mark.parametrize("scale", [1.0, 0.05, 20.0])
def test_sym_eig3_against_numpy_and_jax(rng, scale):
    A = _sym(rng, 200, 3, scale)
    ev_t, v_t = te.sym_eig3_smallest(torch.from_numpy(A))
    ev_j, v_j = je.sym_eig3_smallest(jnp.asarray(A))
    w, V = np.linalg.eigh(A.astype(np.float64))
    mag = np.abs(w).max(axis=1, keepdims=True)
    # closed-form (Cardano) eigenvalues in f32: a few 1e-6 of the spectrum's
    # magnitude; the same formula in both packages agrees tighter
    np.testing.assert_allclose(ev_t.numpy() / mag, w / mag, atol=2e-5)
    np.testing.assert_allclose(ev_t.numpy() / mag, np.asarray(ev_j) / mag,
                               atol=2e-6)
    # eigenvector up to sign, where the smallest eigenvalue is separated
    sep = (w[:, 1] - w[:, 0]) / mag[:, 0] > 0.05
    dot_np = np.abs(np.sum(v_t.numpy() * V[:, :, 0], axis=1))
    assert (dot_np[sep] > 1 - 1e-3).all()
    dot_j = np.sum(v_t.numpy() * np.asarray(v_j), axis=1)
    assert (dot_j[sep] > 1 - 1e-4).all()  # same sign convention too


def test_sym_eig3_degenerate_fallback():
    A = torch.eye(3)[None].repeat(4, 1, 1) * 2.0
    _, v = te.sym_eig3_smallest(A)
    np.testing.assert_array_equal(v.numpy(), np.tile([0, 0, 1.0], (4, 1)))
    _, vz = te.sym_eig3_smallest(torch.zeros(2, 3, 3))
    np.testing.assert_array_equal(vz.numpy(), np.tile([0, 0, 1.0], (2, 1)))


def test_sym_eig2_against_numpy_and_jax(rng):
    A = _sym(rng, 200, 2)
    ev_t, v_t = te.sym_eig2_smallest(torch.from_numpy(A))
    ev_j, v_j = je.sym_eig2_smallest(jnp.asarray(A))
    w, V = np.linalg.eigh(A.astype(np.float64))
    np.testing.assert_allclose(ev_t.numpy(), w, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(ev_t.numpy(), np.asarray(ev_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(v_t.numpy(), np.asarray(v_j), atol=1e-5)
    assert (np.abs(np.sum(v_t.numpy() * V[:, :, 0], axis=1)) > 1 - 1e-3).all()


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("batch", [(), (7,), (3, 5)])
def test_eig_wrappers_on_the_cpu_run_the_plain_forms(rng, dim, batch):
    """A CPU tensor takes the closed forms in tensor operations (the kernel's
    plain version), counts no launch and keeps its batch shape."""
    wrapper, plain = ((te.sym_eig3_smallest, te.sym_eig3_plain) if dim == 3
                      else (te.sym_eig2_smallest, te.sym_eig2_plain))
    n = int(np.prod(batch)) if batch else 1
    A = torch.from_numpy(_sym(rng, n, dim)).reshape(*batch, dim, dim)
    before = wrapper.launches
    ev, v = wrapper(A)
    ev_p, v_p = plain(A)
    assert wrapper.launches == before
    assert ev.shape == (*batch, dim) and v.shape == (*batch, dim)
    np.testing.assert_array_equal(ev.numpy(), ev_p.numpy())
    np.testing.assert_array_equal(v.numpy(), v_p.numpy())
    # ascending, and the vector is of unit length
    assert bool((ev[..., 1:] >= ev[..., :-1]).all())
    np.testing.assert_allclose(torch.linalg.norm(v, dim=-1).numpy(), 1.0,
                               atol=1e-5)


# ---------------------------------------------------------------- voxels

def _interior_cloud(rng, n, dim, vox):
    """Points strictly inside their voxel (>= 5 % of an edge from every
    face): the two packages may round ``x / vox`` differently for a point
    on a voxel face, which is not what these tests are about."""
    cells = rng.integers(-6, 6, size=(n, dim))
    frac = rng.uniform(0.05, 0.95, size=(n, dim))
    return ((cells + frac) * vox).astype(np.float32)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("method", [0, 1, 2, 3])
def test_voxel_select_matches_jax(rng, dim, method):
    vox = 0.5
    n = 1500
    pts = _interior_cloud(rng, n, dim, vox)
    mask = rng.random(n) < 0.85
    key = jax.random.PRNGKey(7)
    # the reference draws its tie-break priorities from its key; the port
    # is handed the very same numbers
    prio = np.asarray(jax.random.randint(key, (n,), 0, 1 << 15,
                                         dtype=jnp.int32))
    keep_j, cen_j = jv.voxel_select(jnp.asarray(pts), jnp.asarray(mask), vox,
                                    method=method, key=key)
    keep_t, cen_t = tv.voxel_select(torch.from_numpy(pts),
                                    torch.from_numpy(mask), vox,
                                    method=method,
                                    prio15=torch.from_numpy(prio))
    np.testing.assert_array_equal(keep_t.numpy(), np.asarray(keep_j))
    kept = keep_t.numpy()
    # one representative per occupied voxel
    vc = np.floor(pts[mask] / vox).astype(np.int64)
    assert kept.sum() == len(np.unique(vc, axis=0))
    assert not kept[~mask].any()
    if method == 2:
        # centroids: segment sums in a different order, f32
        np.testing.assert_allclose(cen_t.numpy()[kept],
                                   np.asarray(cen_j)[kept], atol=1e-5)


def test_voxel_select_first_is_lowest_index(rng):
    pts = _interior_cloud(rng, 800, 3, 1.0)
    mask = np.ones(800, bool)
    keep, _ = tv.voxel_select(torch.from_numpy(pts), torch.from_numpy(mask),
                              1.0, method=0)
    vc = np.floor(pts).astype(np.int64)
    _, first = np.unique(vc, axis=0, return_index=True)
    np.testing.assert_array_equal(np.sort(np.nonzero(keep.numpy())[0]),
                                  np.sort(first))


def test_voxel_coords_matches_jax(rng):
    pts = _interior_cloud(rng, 500, 3, 0.15)
    np.testing.assert_array_equal(
        tv.voxel_coords(torch.from_numpy(pts), 0.15).numpy(),
        np.asarray(jv.voxel_coords(jnp.asarray(pts), 0.15)))


def test_octree_coarsening_is_queued():
    """Once queued, now ported: maxPointByNode > 1 coarsens sparse cells as
    the JAX package does (the full parity is tests/test_torch_octree_k.py)."""
    pts = np.array([[0.05, 0.05, 0.05], [0.2, 0.05, 0.05],
                    [0.05, 0.35, 0.05], [300.0, 3.0, 3.0]], np.float32)
    mask = np.ones(4, bool)
    kt, _ = tv.voxel_select(torch.from_numpy(pts), torch.from_numpy(mask),
                            0.15, max_point_by_node=4)
    kj, _ = jv.voxel_select(jnp.asarray(pts), jnp.asarray(mask), 0.15,
                            max_point_by_node=4)
    np.testing.assert_array_equal(kt.numpy(), np.asarray(kj))
    assert kt.numpy().tolist() == [True, False, False, True]
