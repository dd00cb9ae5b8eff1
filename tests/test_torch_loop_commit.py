"""``ops/graph_loop.py::loop_commit`` on the CPU: one ICP iteration's commit
of the loop state (``T``, ``it``, ``done``, the differential checker's
window, overlap, rms, the matcher's overflow) against the end of the JAX
package's loop body (``norlab_icp_mapper_tpu/icp/engine.py:599-621``,
written out here: it is a closure inside the JAX solve), on the same numpy
state and increment.

The JAX ``lax.while_loop`` runs no body once ``done || it == max_iter``;
the port's commit runs and must keep every bit.  Where the body runs, T and
the window agree within 1e-6 (the port spells the norms and the window
means out in index order; XLA may fuse or reorder them and its product),
``done`` and ``it`` exactly.  On the card the kernel is held against this plain version
bit for bit by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from norlab_icp_mapper_tpu.icp.engine import _rot_angle as jax_rot_angle
from norlab_icp_mapper_tpu_torch.ops import graph_loop as G

MAX_ITER = 30


def rotation(rng, angle, dim):
    if dim == 2:
        c, s = np.cos(angle), np.sin(angle)
        return np.array([[c, -s], [s, c]])
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    K = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return np.eye(3) + np.sin(angle) * K + (1 - np.cos(angle)) * K @ K


def transform(rng, angle, shift, dim):
    T = np.eye(dim + 1)
    T[:dim, :dim] = rotation(rng, angle, dim)
    T[:dim, dim] = rng.normal(size=dim) * shift
    return T.astype(np.float32)


# name -> (kwargs of the state, checkers); every state in 2-D and 3-D
STATES = {
    # the body does not run in JAX; the port's commit keeps every bit
    "inactive_done": dict(it=5, done=True),
    "inactive_counter": dict(it=MAX_ITER, done=False),
    # the window not yet full: small steps do not stop the loop
    "diff_warming": dict(it=1, small=True, diff=(1e-3, 1e-3, 4)),
    # a full window of small steps: the checker trips
    "diff_trips": dict(it=6, small=True, diff=(1e-3, 1e-3, 4)),
    # a full window, but this step is large: it does not trip
    "diff_holds": dict(it=6, small=False, diff=(1e-3, 1e-3, 4)),
    # the new T beyond the bound (translation), then within it
    "bound_trips": dict(it=2, bound=(0.5, 0.05)),
    "bound_holds": dict(it=2, bound=(1.0, 10.0)),
    # both checkers, smoothing over one row
    "both_checkers": dict(it=0, small=True, diff=(5e-2, 5e-2, 1),
                          bound=(1.0, 10.0)),
    # the identity minimizer: dT = I, stop after the iteration
    "identity": dict(it=0, identity=True),
}


def make_state(rng, dim, it=0, done=False, small=False, diff=None,
               bound=None, identity=False):
    T = transform(rng, 0.3, 0.3, dim)
    if identity:
        dT = np.eye(dim + 1, dtype=np.float32)
    elif small:
        dT = transform(rng, 2e-4, 1e-4, dim)
    else:
        dT = transform(rng, 0.05, 0.05, dim)
    rows = diff[2] if diff else 1
    hist = np.full((rows, 2), np.inf, np.float32)
    filled = min(it, rows)
    hist[:filled] = rng.uniform(0, 4e-4, size=(filled, 2))
    return dict(T=T, dT=dT, it=np.int32(it), done=bool(done), hist=hist,
                overlap=np.float32(0.25), overlap_new=np.float32(0.8125),
                rms=np.float32(0.5), rms_new=np.float32(0.0625),
                overflow=np.int64(3), overflow_new=np.int64(2),
                diff=diff, bound=bound, identity=identity)


def jax_body_commit(st, dim):
    """The JAX body from ``dT`` on: ``T_new``, ``it + 1``, the checkers,
    the rolled window; the identity minimizer's rms is 0.  ``None`` where
    ``lax.while_loop``'s condition does not let the body run."""
    if st["done"] or st["it"] >= MAX_ITER:
        return None
    dT, T = jnp.asarray(st["dT"]), jnp.asarray(st["T"])
    T_new = dT @ T
    new_done = jnp.array(st["identity"])
    dtrans = jnp.linalg.norm(dT[:dim, dim])
    drot = jax_rot_angle(dT[:dim, :dim])
    hist = jnp.roll(jnp.asarray(st["hist"]), 1, axis=0).at[0].set(
        jnp.array([dtrans, drot]))
    it = jnp.int32(st["it"])
    if st["diff"] is not None:
        min_t, min_r, smooth = st["diff"]
        means = jnp.mean(hist, axis=0)
        new_done = new_done | ((it + 1 >= smooth) & (means[0] < min_t)
                               & (means[1] < min_r))
    if st["bound"] is not None:
        max_rot, max_trans = st["bound"]
        new_done = new_done | (
            (jax_rot_angle(T_new[:dim, :dim]) > max_rot)
            | (jnp.linalg.norm(T_new[:dim, dim]) > max_trans))
    rms = np.float32(0.0) if st["identity"] else st["rms_new"]
    return dict(T=np.asarray(T_new), it=int(it) + 1, done=bool(new_done),
                hist=np.asarray(hist), overlap=st["overlap_new"], rms=rms)


def torch_state(st):
    t = lambda x, dt: torch.tensor(x, dtype=dt)  # noqa: E731
    return dict(
        dT=torch.from_numpy(st["dT"]), T=torch.from_numpy(st["T"].copy()),
        it=t(st["it"], torch.int32), done=t(st["done"], torch.bool),
        hist=torch.from_numpy(st["hist"].copy()),
        overlap_new=t(st["overlap_new"], torch.float32),
        overlap=t(st["overlap"], torch.float32),
        rms_new=t(st["rms_new"], torch.float32),
        rms=t(st["rms"], torch.float32),
        overflow_new=t(st["overflow_new"], torch.int64),
        overflow=t(st["overflow"], torch.int64))


def commit(fn, st, s):
    """Run ``fn`` (the wrapper or its plain version) as ``_Loop`` does: no
    rms for the identity minimizer (it keeps its 0 of the initial state)."""
    if st["identity"]:
        s["rms"].zero_()
    fn(s["dT"], s["T"], s["it"], s["done"], s["hist"], s["overlap_new"],
       s["overlap"], max_iter=MAX_ITER,
       rms_new=None if st["identity"] else s["rms_new"],
       rms=None if st["identity"] else s["rms"],
       overflow_new=s["overflow_new"], overflow=s["overflow"],
       identity=st["identity"], diff_checker=st["diff"],
       bound_checker=st["bound"])


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("name", list(STATES))
def test_commit_matches_the_jax_body(name, dim):
    rng = np.random.default_rng(10 * list(STATES).index(name) + dim)
    for _ in range(4):
        st = make_state(rng, dim, **STATES[name])
        s = torch_state(st)
        before = {k: v.clone() for k, v in s.items()}
        commit(G.loop_commit_plain, st, s)
        want = jax_body_commit(st, dim)
        if want is None:
            for k, v in before.items():
                assert torch.equal(s[k], v), k  # every bit kept
            continue
        np.testing.assert_allclose(s["T"].numpy(), want["T"], atol=1e-6)
        np.testing.assert_allclose(s["hist"].numpy(), want["hist"],
                                   atol=1e-6)
        assert int(s["it"]) == want["it"]
        assert bool(s["done"]) == want["done"]
        assert float(s["overlap"]) == want["overlap"]
        assert float(s["rms"]) == want["rms"]
        assert int(s["overflow"]) == int(st["overflow"] + st["overflow_new"])
    expect_done = {"diff_trips": True, "diff_warming": False,
                   "diff_holds": False, "bound_trips": True,
                   "bound_holds": False, "identity": True}
    if name in expect_done:
        assert bool(s["done"]) == expect_done[name], name


def test_wrapper_on_the_cpu_is_the_plain_version_and_checks_inputs():
    rng = np.random.default_rng(7)
    st = make_state(rng, 3, it=6, small=True, diff=(1e-3, 1e-3, 4),
                    bound=(1.0, 10.0))
    a, b = torch_state(st), torch_state(st)
    before = G.loop_commit.launches
    commit(G.loop_commit, st, a)
    commit(G.loop_commit_plain, st, b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert G.loop_commit.launches == before  # the plain path launches none
    s = torch_state(st)
    args = (s["dT"], s["T"], s["it"], s["done"], s["hist"],
            s["overlap_new"], s["overlap"])
    with pytest.raises(ValueError, match="WhileBody on the CPU"):
        G.loop_commit(*args, max_iter=MAX_ITER, body=G.WhileBody(1, 30))
    with pytest.raises(ValueError, match="int32"):
        G.loop_commit(*args[:2], s["it"].long(), *args[3:],
                      max_iter=MAX_ITER)
    with pytest.raises(ValueError, match="go together"):
        G.loop_commit(*args, max_iter=MAX_ITER, rms=s["rms"])
    with pytest.raises(ValueError, match=r"\[S, 2\]"):
        G.loop_commit(*args[:4], torch.zeros(4, 3), *args[5:],
                      max_iter=MAX_ITER)


def test_masked_commit_after_the_stop_changes_no_bit():
    """Ten commits after a checker stopped the loop leave the state as the
    stopping commit left it (the WHILE node's masked tail)."""
    rng = np.random.default_rng(11)
    st = make_state(rng, 3, it=6, small=True, diff=(1e-3, 1e-3, 4))
    s = torch_state(st)
    commit(G.loop_commit_plain, st, s)
    assert bool(s["done"])
    stopped = {k: v.clone() for k, v in s.items()}
    for _ in range(10):
        s["dT"] = torch.from_numpy(transform(rng, 0.1, 0.1, 3))
        commit(G.loop_commit_plain, st, s)
    for k in ("T", "it", "done", "hist", "overlap", "rms", "overflow"):
        assert torch.equal(s[k], stopped[k]), k
