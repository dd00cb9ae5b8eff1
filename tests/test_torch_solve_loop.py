"""The ICP loop as device state and one masked body (``icp/engine.py``).

On a card the port runs the solve as a CUDA graph: the initial state, then a
WHILE node that repeats a body of ``rematch_every`` iterations until
``done || it == max_iter``.  The body therefore runs past the reference's
exact stop (by up to ``rematch_every - 1`` iterations, and here by many
more): every state tensor is held by ``where(active, new, old)``, so an
iteration after the stop must change no bit.  These tests run the same body
on the CPU, where it is the same code, against the Python loop that reads
``done`` before every iteration and against the JAX engine.
"""
import pytest
import torch

from norlab_icp_mapper_tpu import PointBatch as JBatch
from norlab_icp_mapper_tpu_torch import PointBatch as TBatch
from norlab_icp_mapper_tpu_torch.icp import engine as te
from norlab_icp_mapper_tpu_torch.ops.nn import knn
from norlab_icp_mapper_tpu_torch.ops.nn_sweep import sweep_knn

from test_torch_icp import (_assert_same_registration, _config, _engines,
                            _scene)


def _args(et, reading):
    t = TBatch.from_numpy(reading, device="cpu")
    ref = et._ref
    return (t.positions, t.mask, ref.positions, et.check_reference(ref),
            ref.mask, et._ref_pack)


def _with_bound(cfg, max_rot, max_trans):
    cfg["transformationCheckers"] = cfg["transformationCheckers"] + [
        {"BoundTransformationChecker": {"maxRotationNorm": max_rot,
                                        "maxTranslationNorm": max_trans}}]
    return cfg


def _while_node(loop):
    """What the graph's WHILE node does: the condition, tested before
    every run of the body, is ``!done && it < max_iter``."""
    loop.start()
    bodies = 0
    while not bool(loop.done) and int(loop.it) < loop.max_iter:
        loop.body()
        bodies += 1
    return loop.outputs(), bodies


@pytest.mark.parametrize("bound", [None, (0.5, 0.02)],
                         ids=["checkers", "bound"])
@pytest.mark.parametrize("rematch", [1, 3])
@pytest.mark.parametrize("dim", [2, 3])
def test_masked_body_changes_no_bit_after_the_stop(rng, monkeypatch, dim,
                                                   rematch, bound):
    """The body run 2 * max_iter times gives the Python loop's T,
    iterations, overlap and rms bit for bit: the differential checker
    stops the plain case, the bound checker (tighter than the ~8 cm
    offset) the other."""
    world, normals, _, reading = _scene(rng, dim)
    cfg = _config("PointToPlaneErrorMinimizer")
    if bound is not None:
        cfg = _with_bound(cfg, *bound)
    _, et = _engines(cfg, world, normals, dim, monkeypatch, rematch)
    args = _args(et, reading)
    kw = et.solve_config()
    want = te._Loop(*args, **kw).run()
    loop = te._Loop(*args, **kw)
    loop.start()
    for _ in range(2 * loop.max_iter):
        loop.body()
    got = loop.outputs()
    for name, a, b in zip(("T", "overlap", "iterations", "rms"), got, want):
        assert torch.equal(a, b), name
    assert bool(loop.done)  # a checker stopped it, not the counter
    if bound is None:
        assert 1 < int(got[2]) < loop.max_iter
    else:
        assert int(got[2]) < 4  # stopped at the first pose beyond the bound


@pytest.mark.parametrize("rematch", [1, 3])
@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("matcher", ["sweep", "brute_force"])
def test_while_node_schedule_matches_the_reference(rng, monkeypatch, dim,
                                                   rematch, matcher):
    """The solve as the WHILE node runs it, against the JAX engine's
    ``lax.while_loop``: iterations within 1 and the pose within the
    tolerances of ``test_torch_icp.py``; the node ran one body per
    ``rematch_every`` iterations, the last one possibly masked in part."""
    world, normals, _, reading = _scene(rng, dim)
    cfg = _config("PointToPlaneErrorMinimizer")
    if matcher == "brute_force":
        cfg["matcher"] = {"KDTreeMatcher": {"knn": 3}}
    ej, et = _engines(cfg, world, normals, dim, monkeypatch, rematch)
    rj = ej(JBatch.from_numpy(reading))
    (T, overlap, it, rms, _), bodies = _while_node(
        te._Loop(*_args(et, reading), **et.solve_config()))
    _assert_same_registration(
        rj, te.ICPResult(T, overlap, int(it), rms), dim)
    assert bodies == -(-int(it) // rematch)


@pytest.mark.parametrize("dim", [2, 3])
def test_identity_minimizer_under_the_while_node(rng, monkeypatch, dim):
    """The identity minimizer stops after one iteration, as the
    reference's, with its overlap."""
    world, normals, _, reading = _scene(rng, dim)
    cfg = _config("IdentityErrorMinimizer")
    ej, et = _engines(cfg, world, normals, dim, monkeypatch, 3)
    rj = ej(JBatch.from_numpy(reading))
    (T, overlap, it, _, _), bodies = _while_node(
        te._Loop(*_args(et, reading), **et.solve_config()))
    assert int(it) == int(rj.iterations) == 1 and bodies == 1
    assert torch.equal(T, torch.eye(dim + 1))
    assert abs(float(overlap) - float(rj.overlap)) < 1e-3


def test_graph_replay_counts_one_body_per_rematch_period():
    """A solve graph's wrappers count their launches at capture; a replay
    adds the captured body's launches once per run of the body."""
    saved = [(f.launches, dict(f.launches_by_shape))
             for f in (sweep_knn, knn)]
    try:
        sweep_knn.launches, sweep_knn.launches_by_shape = 0, {}
        knn.launches, knn.launches_by_shape = 0, {}
        replay = te.GraphReplay(((1, {(3, 3): 1}), (0, {})), body_len=3)
        replay.count(7)  # 3 bodies: iterations 0-2, 3-5, 6 (+2 masked)
        replay.count(3)  # 1 body
        assert sweep_knn.launches == 4
        assert sweep_knn.launches_by_shape == {(3, 3): 4}
        assert knn.launches == 0 and knn.launches_by_shape == {}
    finally:
        (sweep_knn.launches, sweep_knn.launches_by_shape), \
            (knn.launches, knn.launches_by_shape) = saved
