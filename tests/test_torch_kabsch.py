"""``ops/kabsch.py`` on the CPU: ``kabsch_plain`` (the arithmetic of
``csrc/kabsch.cu``) against the JAX package's weighted Kabsch, the
``jnp.linalg.svd`` form of its point-to-point minimizer
(``norlab_icp_mapper_tpu/icp/engine.py:547-560``), written out here on the
same ``H`` (it is a closure inside the JAX solve).

Tolerances: R within 1e-5 and ``det R`` = 1 within 1e-5 (both packages in
f32; the rotation is the same function of ``H``, reached by an SVD in one
and a Jacobi eigensolve in the other); t within 1e-5 relative to the means'
size."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu_torch.ops import kabsch as K


def jax_kabsch(H, mu_p, mu_q):
    """The JAX minimizer's SVD block on ``H`` and the means."""
    H, mu_p, mu_q = (jnp.asarray(x) for x in (H, mu_p, mu_q))
    dim = H.shape[0]
    U, _, Vt = jnp.linalg.svd(H)
    det = jnp.linalg.det(Vt.T @ U.T)
    S = jnp.diag(jnp.concatenate([jnp.ones((dim - 1,), jnp.float32),
                                  det[None]]))
    R = Vt.T @ S @ U.T
    t = mu_q - R @ mu_p
    return np.asarray(R), np.asarray(t)


def rotation(rng, angle, dim):
    if dim == 2:
        c, s = np.cos(angle), np.sin(angle)
        return np.array([[c, -s], [s, c]])
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    Kx = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                   [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * Kx + (1 - np.cos(angle)) * Kx @ Kx


def moments(rng, kind, dim, n=400):
    """Seeded weighted pairs of one kind and their ``(H, mu_p, mu_q)`` in
    float32, with the true rotation."""
    scale = np.array([6.0, 3.0, 1.5][:dim])
    p = rng.normal(size=(n, dim)) * scale + 20.0
    angle = {"conditioned": 0.6, "near_identity": 1e-4, "planar": 0.3,
             "reflection": 0.3, "collinear": 0.2}[kind]
    if kind == "planar":
        p[:, 2] = 20.0  # a plane: H of rank 2
    if kind == "collinear":
        p = 20.0 + rng.normal(size=(n, 1)) * np.array([[1.0, 2.0, 0.5]])
    R = rotation(rng, angle, dim)
    q = p @ R.T + np.array([0.3, -0.2, 0.1][:dim])
    q += rng.normal(size=q.shape) * (0.0 if kind == "collinear" else 0.005)
    if kind == "reflection":
        q[:, -1] = 2 * q[:, -1].mean() - q[:, -1]  # det(H) < 0
    w = rng.uniform(0.2, 1.0, size=n)
    mu_p = (w[:, None] * p).sum(0) / w.sum()
    mu_q = (w[:, None] * q).sum(0) / w.sum()
    H = ((p - mu_p) * w[:, None]).T @ (q - mu_q)
    f = lambda x: x.astype(np.float32)
    return f(H), f(mu_p), f(mu_q), R


CASES = [("conditioned", 3), ("near_identity", 3), ("planar", 3),
         ("reflection", 3), ("conditioned", 2), ("near_identity", 2),
         ("reflection", 2)]


@pytest.mark.parametrize("kind,dim", CASES)
def test_plain_matches_the_jax_svd_form(rng, kind, dim):
    for _ in range(5):
        H, mu_p, mu_q, _ = moments(rng, kind, dim)
        Rj, tj = jax_kabsch(H, mu_p, mu_q)
        dT = K.kabsch_plain(*(torch.from_numpy(x) for x in (H, mu_p, mu_q)))
        dT = dT.numpy()
        assert dT.shape == (dim + 1, dim + 1)
        R, t = dT[:dim, :dim], dT[:dim, dim]
        np.testing.assert_allclose(R, Rj, atol=1e-5)
        assert abs(np.linalg.det(R.astype(np.float64)) - 1.0) < 1e-5
        np.testing.assert_allclose(t, tj, atol=1e-5 * np.abs(mu_q).max())
        np.testing.assert_array_equal(dT[dim], np.eye(dim + 1)[dim])


def test_near_identity_keeps_its_digits(rng):
    """A 1e-4 rad increment: the rotation out of the quaternion matches
    float64's within 1e-6 (the differential checker's stop is at 1e-3)."""
    for _ in range(5):
        H, mu_p, mu_q, _ = moments(rng, "near_identity", 3)
        dT = K.kabsch_plain(*(torch.from_numpy(x) for x in (H, mu_p, mu_q)))
        Hd = H.astype(np.float64)
        U, _, Vt = np.linalg.svd(Hd)
        D = np.diag([1.0, 1.0, np.linalg.det(Vt.T @ U.T)])
        R64 = Vt.T @ D @ U.T
        assert np.abs(dT.numpy()[:3, :3] - R64).max() < 1e-6


def test_collinear_pairs_fix_the_line_only(rng):
    """Rank-1 ``H``: the rotation about the line is free in both packages,
    so only where R takes the line's direction is held."""
    H, mu_p, mu_q, R_true = moments(rng, "collinear", 3)
    dT = K.kabsch_plain(*(torch.from_numpy(x) for x in (H, mu_p, mu_q)))
    R = dT.numpy()[:3, :3]
    line = np.array([1.0, 2.0, 0.5]) / np.linalg.norm([1.0, 2.0, 0.5])
    np.testing.assert_allclose(R @ line, R_true @ line, atol=1e-5)
    assert abs(np.linalg.det(R.astype(np.float64)) - 1.0) < 1e-5


def test_batched_and_degenerate_inputs():
    """A batch gives each problem's own increment; ``H = 0`` gives the
    identity rotation and ``t = mu_q - mu_p``."""
    rng = np.random.default_rng(3)
    probs = [moments(rng, k, 3) for k in ("conditioned", "planar")]
    H = torch.from_numpy(np.stack([p[0] for p in probs]))
    mp = torch.from_numpy(np.stack([p[1] for p in probs]))
    mq = torch.from_numpy(np.stack([p[2] for p in probs]))
    out = K.kabsch_plain(H, mp, mq)
    for i in range(2):
        assert torch.equal(out[i], K.kabsch_plain(H[i], mp[i], mq[i]))
    for dim in (2, 3):
        z = torch.zeros(dim, dim)
        a, b = torch.arange(dim, dtype=torch.float32), torch.ones(dim)
        dT = K.kabsch_plain(z, a, b)
        assert torch.equal(dT[:dim, :dim], torch.eye(dim))
        assert torch.equal(dT[:dim, dim], b - a)


def test_wrapper_on_the_cpu_is_the_plain_version_and_checks_inputs():
    rng = np.random.default_rng(5)
    H, mu_p, mu_q, _ = moments(rng, "conditioned", 3)
    args = [torch.from_numpy(x) for x in (H, mu_p, mu_q)]
    before = K.kabsch.launches
    assert torch.equal(K.kabsch(*args), K.kabsch_plain(*args))
    assert K.kabsch.launches == before  # the plain path launches nothing
    with pytest.raises(ValueError, match="D in"):
        K.kabsch(torch.zeros(4, 4), torch.zeros(4), torch.zeros(4))
    with pytest.raises(ValueError, match="means"):
        K.kabsch(args[0], args[1][:2], args[2])
    with pytest.raises(ValueError, match="float32"):
        K.kabsch(args[0].double(), args[1], args[2])
