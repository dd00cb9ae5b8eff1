"""``ops/kabsch.py`` on the CPU.

``kabsch_plain`` (the solve of ``csrc/kabsch.cu``) against the JAX
package's weighted Kabsch, the ``jnp.linalg.svd`` form of its
point-to-point minimizer (``norlab_icp_mapper_tpu/icp/engine.py:547-560``),
written out here on the same ``H`` (it is a closure inside the JAX solve).
Tolerances: R within 1e-5 and ``det R`` = 1 within 1e-5 (both packages in
f32; the rotation is the same function of ``H``, reached by an SVD in one
and a Jacobi eigensolve in the other); t within 1e-5 relative to the means'
size.

``p2p_step_plain`` (the whole minimizer: float64 moments of the pairs, then
the solve) against that minimizer from the pairs on (centred f32 sums, the
SVD), with masked rows, k = 1 and 3, 2-D and 3-D: ``dT`` and the rms within
1e-5 near the origin; 60 m from it, within 1e-5 beyond the JAX form's own
f32 error against float64.  Against float64 numpy: the moments
within 1e-12 of the sums' absolute size, R within 1e-6 and t within 1e-6
of the coordinates' size (t is f32: at 60 m one ulp is 3.8e-6).  Split in
two halves whose moments are summed, as two ranks' ``all_reduce`` sums
them: within 1e-6 of the one-rank step.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu_torch.ops import kabsch as K


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and small CPU ops split over every core slow down when the cores are
    shared."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


# --------------------------------------------------------------------------
# from the pairs: p2p_step
# --------------------------------------------------------------------------

def jax_point_to_point(p, q, w):
    """The JAX minimizer from the weighted pairs on: centred f32 sums, the
    SVD, ``t``, and the rms of the weighted pairs."""
    p, q, w = (jnp.asarray(x) for x in (p, q, w))
    wsum = jnp.maximum(jnp.sum(w), 1e-9)
    wk = w[..., None]
    mu_p = jnp.sum(wk * p[:, None, :], axis=(0, 1)) / wsum
    mu_q = jnp.sum(wk * q, axis=(0, 1)) / wsum
    P = (p[:, None, :] - mu_p) * wk
    Q = q - mu_q
    H = jnp.einsum("nkd,nke->nde", P, Q).sum(0)
    R, t = jax_kabsch(H, mu_p, mu_q)
    diff = p[:, None, :] - q
    rms = jnp.sqrt(jnp.sum(w * jnp.sum(diff * diff, -1)) / wsum)
    return R, t, float(rms)


def pairs(rng, dim, k, n=600, offset=60.0, angle=0.2):
    """Weighted pairs as the matcher leaves them: the reading ``p`` near
    ``offset`` on every axis, ``k`` matches each (the true one moved by a
    rigid motion plus noise), a fifth of the rows masked (weight 0, their
    matches the map's first point) and trimmed pairs at weight 0."""
    scale = np.array([6.0, 3.0, 1.5][:dim])
    p = rng.normal(size=(n, dim)) * scale + offset
    R = rotation(rng, angle, dim)
    t = np.array([0.3, -0.2, 0.1][:dim])
    q = (p @ R.T + t)[:, None, :] + rng.normal(size=(n, k, dim)) * 0.01
    w = (rng.random((n, k)) < 0.85).astype(np.float64)
    masked = rng.random(n) < 0.2
    w[masked] = 0.0
    q[masked] = q[0, 0]
    f = lambda x: x.astype(np.float32)  # noqa: E731
    return f(p), f(q), f(w)


def numpy_moments(p, q, w):
    """The float64 moments and their absolute sums (the rounding's scale)."""
    p64, q64, w64 = (x.astype(np.float64) for x in (p, q, w))
    wp = w64[..., None] * p64[:, None, :]
    wq = w64[..., None] * q64
    e = ((p64[:, None, :] - q64) ** 2).sum(-1)
    parts = [w64, wp, wq, wp[..., :, None] * q64[..., None, :], w64 * e]
    dims = [(0, 1)] * 5
    m = np.concatenate([np.atleast_1d(x.sum(a)).reshape(-1)
                        for x, a in zip(parts, dims)])
    size = np.concatenate([np.atleast_1d(np.abs(x).sum(a)).reshape(-1)
                           for x, a in zip(parts, dims)])
    return m, size


def numpy_step(m, dim):
    """R, t and the rms from float64 moments by a float64 SVD."""
    wsum = max(m[0], 1e-9)
    sp, sq = m[1:1 + dim], m[1 + dim:1 + 2 * dim]
    H = m[1 + 2 * dim:1 + 2 * dim + dim * dim].reshape(dim, dim) \
        - np.outer(sp, sq) / wsum
    U, _, Vt = np.linalg.svd(H)
    D = np.eye(dim)
    D[-1, -1] = np.linalg.det(Vt.T @ U.T)
    R = Vt.T @ D @ U.T
    return R, sq / wsum - R @ (sp / wsum), np.sqrt(m[-1] / wsum)


STEP_CASES = [(3, 1), (3, 3), (2, 1), (2, 3)]


@pytest.mark.parametrize("offset", [0.0, 60.0])
@pytest.mark.parametrize("dim,k", STEP_CASES)
def test_p2p_step_matches_the_jax_minimizer(rng, dim, k, offset):
    """R, t and the rms within 1e-5 of the JAX form.  At 60 m the JAX form's
    centred f32 sums are themselves off float64's answer by up to ~8e-5 in
    t (the cancellation the float64 moments avoid): there the port must lie
    within 1e-5 of JAX beyond JAX's own distance from float64."""
    for _ in range(3):
        p, q, w = pairs(rng, dim, k, offset=offset)
        Rj, tj, rms_j = jax_point_to_point(p, q, w)
        R64, t64, _ = numpy_step(numpy_moments(p, q, w)[0], dim)
        dT, rms = K.p2p_step_plain(*(torch.from_numpy(x) for x in (p, q, w)))
        dT = dT.numpy()
        assert dT.shape == (dim + 1, dim + 1)
        slack_R = np.abs(Rj - R64) if offset else 0.0
        slack_t = np.abs(tj - t64) if offset else 0.0
        assert np.all(np.abs(dT[:dim, :dim] - Rj) <= 1e-5 + slack_R)
        assert np.all(np.abs(dT[:dim, dim] - tj) <= 1e-5 + slack_t)
        np.testing.assert_array_equal(dT[dim], np.eye(dim + 1)[dim])
        assert abs(float(rms) - rms_j) < 1e-5


@pytest.mark.parametrize("dim,k", STEP_CASES)
def test_p2p_step_against_float64(rng, dim, k):
    for _ in range(3):
        p, q, w = pairs(rng, dim, k)
        args = [torch.from_numpy(x) for x in (p, q, w)]
        m = K.p2p_moments_plain(*args)
        assert m.dtype == torch.float64 and m.shape == (K.n_moments(dim),)
        m_np, size = numpy_moments(p, q, w)
        assert np.all(np.abs(m.numpy() - m_np) <= 1e-12 * size)
        R64, t64, rms64 = numpy_step(m_np, dim)
        dT, rms = K.p2p_step_plain(*args)
        dT = dT.numpy().astype(np.float64)
        assert np.abs(dT[:dim, :dim] - R64).max() < 1e-6
        assert np.abs(dT[:dim, dim] - t64).max() < 1e-6 * np.abs(p).max()
        assert abs(float(rms) - rms64) < 1e-6


@pytest.mark.parametrize("dim,k", STEP_CASES)
def test_moments_of_two_halves_summed_as_two_ranks(rng, dim, k):
    p, q, w = (torch.from_numpy(x) for x in pairs(rng, dim, k))
    half = p.shape[0] // 2
    m = (K.p2p_moments(p[:half], q[:half], w[:half])
         + K.p2p_moments(p[half:], q[half:], w[half:]))
    dT2, rms2 = K.kabsch_from_moments(m, dim)
    dT1, rms1 = K.p2p_step(p, q, w)
    assert (dT2 - dT1).abs().max() < 1e-6
    assert abs(float(rms2) - float(rms1)) < 1e-6


def test_p2p_wrappers_on_the_cpu_are_the_plain_versions_and_check_inputs():
    rng = np.random.default_rng(9)
    p, q, w = (torch.from_numpy(x) for x in pairs(rng, 3, 3, n=64))
    before = (K.p2p_step.launches, K.kabsch.launches)
    dT, rms = K.p2p_step(p, q, w)
    dTp, rmsp = K.p2p_step_plain(p, q, w)
    assert torch.equal(dT, dTp) and torch.equal(rms, rmsp)
    m = K.p2p_moments(p, q, w)
    assert torch.equal(m, K.p2p_moments_plain(p, q, w))
    dTm, rmsm = K.kabsch_from_moments(m, 3)
    assert torch.equal(dTm, dT) and torch.equal(rmsm, rms)
    # the plain path launches nothing
    assert (K.p2p_step.launches, K.kabsch.launches) == before
    # no weight at all: the identity rotation, t = 0 (wsum clamped)
    dT0, rms0 = K.p2p_step(p, q, torch.zeros_like(w))
    assert torch.equal(dT0, torch.eye(4)) and float(rms0) == 0.0
    with pytest.raises(ValueError, match="D in"):
        K.p2p_step(torch.zeros(4, 4), torch.zeros(4, 1, 4), torch.zeros(4, 1))
    with pytest.raises(ValueError, match="q is"):
        K.p2p_step(p, q[:, :, :2], w)
    with pytest.raises(ValueError, match="w is"):
        K.p2p_step(p, q, w[:, :1])
    with pytest.raises(ValueError, match="float32"):
        K.p2p_step(p.double(), q, w)
    with pytest.raises(ValueError, match="float64 moments"):
        K.kabsch_from_moments(m.float(), 3)
