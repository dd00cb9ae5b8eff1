"""Port parity: PointBatch helpers and SE(3)/SE(2) utilities against the JAX
package, same numpy inputs through both (CPU)."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu import points as jp, se3 as jse3
from norlab_icp_mapper_tpu_torch import points as tp, se3 as tse3


def _pair(rng, n, cap, dim=3, desc=None, valid_frac=0.7):
    """The same masked batch in both packages, built from full arrays."""
    pos = rng.normal(size=(cap, dim)).astype(np.float32)
    mask = rng.random(cap) < valid_frac
    mask[n:] = False
    d = {k: rng.normal(size=(cap, w)).astype(np.float32)
         for k, w in (desc or {}).items()}
    bj = jp.PointBatch(jnp.asarray(pos), jnp.asarray(mask),
                       {k: jnp.asarray(v) for k, v in d.items()})
    bt = tp.PointBatch(torch.from_numpy(pos), torch.from_numpy(mask),
                       {k: torch.from_numpy(v) for k, v in d.items()})
    return bj, bt


def _same(bj, bt):
    """Exact equality of every channel, padding rows included: these are
    moves of f32 values, no arithmetic."""
    np.testing.assert_array_equal(np.asarray(bj.positions),
                                  bt.positions.numpy())
    np.testing.assert_array_equal(np.asarray(bj.mask), bt.mask.numpy())
    assert sorted(bj.descriptors) == sorted(bt.descriptors)
    for k in bj.descriptors:
        np.testing.assert_array_equal(np.asarray(bj.descriptors[k]),
                                      bt.descriptors[k].numpy())


@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 320, 321, 1000, 4097,
                               49152, 131072, 100000])
def test_bucket_capacity(n):
    assert tp.bucket_capacity(n) == jp.bucket_capacity(n)


def test_from_numpy_and_to_numpy(rng):
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    desc = {"normals": rng.normal(size=(300, 3)).astype(np.float32),
            "t": rng.normal(size=300).astype(np.float32)}
    bj = jp.PointBatch.from_numpy(pts, desc)
    bt = tp.PointBatch.from_numpy(pts, desc, device="cpu")
    _same(bj, bt)
    assert bt.capacity == 320 and int(bt.count()) == 300
    out = bt.to_numpy()
    np.testing.assert_array_equal(out["positions"], pts)
    np.testing.assert_array_equal(out["t"][:, 0], desc["t"])
    with pytest.raises(ValueError, match="capacity"):
        tp.PointBatch.from_numpy(pts, capacity=10, device="cpu")


@pytest.mark.parametrize("dim", [2, 3])
def test_compact_and_pad(rng, dim):
    bj, bt = _pair(rng, 200, 256, dim, {"normals": dim, "p": 1})
    _same(bj.compact(), bt.compact())
    _same(bj.pad_to(512), bt.pad_to(512))
    assert bt.pad_to(100) is bt
    idx = rng.permutation(256)
    _same(bj.gather(jnp.asarray(idx)), bt.gather(torch.from_numpy(idx)))


def test_insert_order_and_descriptor_union(rng):
    dj, dt = _pair(rng, 300, 512, 3, {"normals": 3})
    sj, st = _pair(rng, 100, 128, 3, {"probabilityDynamic": 1})
    oj = jp.insert(dj, sj)
    ot, dropped = tp.insert(dt, st, return_dropped=True)
    _same(oj, ot)
    assert int(dropped) == 0
    # order: dst's valid points first (compacted), then src's, both in order
    nd = int(dt.count())
    np.testing.assert_array_equal(ot.positions[:nd].numpy(),
                                  dt.positions[dt.mask].numpy())
    np.testing.assert_array_equal(ot.positions[nd:nd + int(st.count())].numpy(),
                                  st.positions[st.mask].numpy())


def test_insert_drops_past_capacity(rng):
    dj, dt = _pair(rng, 250, 256, 3, valid_frac=1.0)
    sj, st = _pair(rng, 100, 128, 3, valid_frac=1.0)
    oj = jp.insert(dj, sj)
    ot, dropped = tp.insert(dt, st, return_dropped=True)
    _same(oj, ot)
    assert int(ot.count()) == 256
    assert int(dropped) == 250 + 100 - 256


@pytest.mark.parametrize("cap", [None, 1024, 300])
def test_concatenate(rng, cap):
    aj, at = _pair(rng, 150, 256, 3, {"normals": 3})
    bj, bt = _pair(rng, 100, 128, 3, {"w": 1})
    _same(jp.concatenate(aj, bj, capacity=cap),
          tp.concatenate(at, bt, capacity=cap))


def test_with_mask_and_descriptor(rng):
    _, bt = _pair(rng, 100, 128, 3)
    keep = torch.from_numpy(rng.random(128) < 0.5)
    out = bt.with_mask(keep)
    assert bool((out.mask == (keep & bt.mask)).all())
    out = bt.with_descriptor("x", torch.ones(128))
    assert out.descriptors["x"].shape == (128, 1)


# ------------------------------------------------------------------ se3

# elementwise f32 trigonometry differs between XLA and torch by a few ulp;
# 1e-6 absolute on O(1) entries is ~8 ulp
_TOL = dict(rtol=0, atol=2e-6)


def _xi_cases():
    return {
        "zero": np.zeros(6),
        "tiny": np.array([1e-4, -2e-4, 3e-4, 1e-5, -2e-5, 1e-5]),
        "taylor_edge": np.array([0.3, 0.1, -0.2, 0.005, 0.006, -0.004]),
        "mid": np.array([0.5, -1.0, 0.25, 0.3, -0.4, 0.2]),
        "near_pi": np.array([1.0, 2.0, -1.0, 1.8, -1.8, 1.8]),  # |w|~3.12
    }


@pytest.mark.parametrize("case", list(_xi_cases()))
def test_exp_log_se3(case):
    xi = _xi_cases()[case].astype(np.float32)
    Tj = np.asarray(jse3.exp_se3(jnp.asarray(xi)))
    Tt = tse3.exp_se3(torch.from_numpy(xi))
    np.testing.assert_allclose(Tt.numpy(), Tj, **_TOL)
    lj = np.asarray(jse3.log_se3(jnp.asarray(Tj)))
    lt = tse3.log_se3(torch.from_numpy(Tj)).numpy()
    # near pi the log divides by sin(theta) ~ 0.02: f32 error is amplified
    tol = 2e-3 if case == "near_pi" else 1e-5
    np.testing.assert_allclose(lt, lj, rtol=0, atol=tol)
    # round trip: exp(log(T)) == T
    back = tse3.exp_se3(torch.from_numpy(lt)).numpy()
    np.testing.assert_allclose(back, Tj, rtol=0, atol=tol)


@pytest.mark.parametrize("w", [0.0, 1e-3, 0.0099, 0.5, -3.0])
def test_exp_se2(w):
    xi = np.array([0.4, -0.7, w], np.float32)
    np.testing.assert_allclose(tse3.exp_se2(torch.from_numpy(xi)).numpy(),
                               np.asarray(jse3.exp_se2(jnp.asarray(xi))),
                               **_TOL)


@pytest.mark.parametrize("dim", [2, 3])
def test_inverse_compose_apply(rng, dim):
    if dim == 3:
        T = np.asarray(jse3.exp_se3(jnp.asarray(
            rng.normal(size=6).astype(np.float32))))
    else:
        T = np.asarray(jse3.exp_se2(jnp.asarray(
            rng.normal(size=3).astype(np.float32))))
    Tt = torch.from_numpy(T)
    np.testing.assert_allclose(tse3.inverse(Tt).numpy(),
                               np.asarray(jse3.inverse(jnp.asarray(T))),
                               **_TOL)
    np.testing.assert_allclose(
        tse3.compose(Tt, tse3.inverse(Tt)).numpy(), np.eye(dim + 1),
        rtol=0, atol=1e-5)
    np.testing.assert_array_equal(tse3.identity(dim).numpy(),
                                  np.asarray(jse3.identity(dim)))
    bj, bt = _pair(rng, 100, 128, dim, {"normals": dim, "p": 1})
    oj, ot = jse3.apply(jnp.asarray(T), bj), tse3.apply(Tt, bt)
    # a [N,D]x[D,D] product: summation order may differ by an ulp
    np.testing.assert_allclose(ot.positions.numpy(), np.asarray(oj.positions),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(ot.descriptors["normals"].numpy(),
                               np.asarray(oj.descriptors["normals"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ot.descriptors["p"].numpy(),
                                  np.asarray(oj.descriptors["p"]))
    np.testing.assert_allclose(
        tse3.apply_points(Tt, bt.positions).numpy(),
        np.asarray(jse3.apply_points(jnp.asarray(T), bj.positions)),
        rtol=0, atol=1e-5)


def test_quat_to_rot(rng):
    q = rng.normal(size=4).astype(np.float32)
    np.testing.assert_allclose(tse3.quat_to_rot(torch.from_numpy(q)).numpy(),
                               np.asarray(jse3.quat_to_rot(jnp.asarray(q))),
                               **_TOL)
