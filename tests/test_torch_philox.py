"""``ops/philox.py`` and the keyed step-filter draws on the CPU.

``philox_plain`` (the arithmetic of ``csrc/philox.cu``, int64 with 16-bit
split products) is held bit for bit against Philox4x32-10 written here in
numpy with uint64 products, which are exact for 32-bit operands, and so is
``philox_keep_plain`` (the keep bit of a RandomSampling filter, drawn on
original rows).  The draws depend on (seed, solve index, ``it``, row, call)
alone; a random step filter keeps a share of the points within a binomial
bound of ``prob``; and a caller-supplied draw source is refused for step
filters on a CUDA device (the refusal needs no card: it is decided before
anything is launched).

The solve's step chain: a row-local chain runs in the solve's (sorted) row
order with the sort as its ``rows`` (``_Loop._stepped_in_rows``,
``ShardedMapperStep._step_mask_in_rows``), any other chain on the reading
permuted back to its original order; both give the same bits."""
import numpy as np
import pytest
import torch

import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch import se3
from norlab_icp_mapper_tpu_torch.draws import DrawSource, KeyedDraws
from norlab_icp_mapper_tpu_torch.filters.core import FilterChain
from norlab_icp_mapper_tpu_torch.icp import engine
from norlab_icp_mapper_tpu_torch.ops import philox as P
from norlab_icp_mapper_tpu_torch.parallel.sharded_map import (
    ShardedMapConfig, ShardedMapperStep)
from norlab_icp_mapper_tpu_torch.points import PointBatch

M32 = np.uint64(0xFFFFFFFF)


def philox_numpy(seed, solve, it, call, n):
    """Philox4x32-10 (Salmon et al., SC'11) over the counters (row // 4,
    it, solve, call) with key (seed lo, seed hi); word row % 4, top 24
    bits as a uniform."""
    blocks = (n + 3) // 4
    s = seed & ((1 << 64) - 1)
    k0, k1 = np.uint64(s & 0xFFFFFFFF), np.uint64(s >> 32)
    c0 = np.arange(blocks, dtype=np.uint64)
    c1 = np.full(blocks, it & 0xFFFFFFFF, np.uint64)
    c2 = np.full(blocks, solve & 0xFFFFFFFF, np.uint64)
    c3 = np.full(blocks, call & 0xFFFFFFFF, np.uint64)
    m0, m1 = np.uint64(0xD2511F53), np.uint64(0xCD9E8D57)
    for r in range(10):
        if r:
            k0 = (k0 + np.uint64(0x9E3779B9)) & M32
            k1 = (k1 + np.uint64(0xBB67AE85)) & M32
        p0, p1 = m0 * c0, m1 * c2
        hi0, lo0 = p0 >> np.uint64(32), p0 & M32
        hi1, lo1 = p1 >> np.uint64(32), p1 & M32
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    words = np.stack([c0, c1, c2, c3], 1).reshape(-1)[:n]
    return (words >> np.uint64(8)).astype(np.float32) * np.float32(2 ** -24)


def t(solve, it):
    return (torch.tensor(solve, dtype=torch.int64),
            torch.tensor(it, dtype=torch.int32))


@pytest.mark.parametrize("seed,solve,it,call,n", [
    (0, 0, 0, 0, 49_152), (1234567, 5, 3, 0, 1001),
    (2 ** 40 + 17, 2 ** 33 + 9, 39, 2, 7), (-3, 11, 2 ** 30, 1, 4096),
    (9, 1, 1, 0, 1), (9, 1, 1, 0, 0)])
def test_plain_bit_for_bit_against_numpy(seed, solve, it, call, n):
    got = P.philox_plain(seed, *t(solve, it), call, n)
    want = philox_numpy(seed, solve, it, call, n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_known_answer_of_the_random123_suite():
    """Philox4x32-10 with counter (0, 0, 0, 0) and key (0, 0): the first
    word of the published known-answer vector, 0x6627e8d5."""
    u = P.philox_plain(0, *t(0, 0), 0, 1)
    assert int(float(u[0]) * 2 ** 24) == 0x6627e8d5 >> 8


def test_draws_depend_on_seed_solve_it_row_and_call_alone():
    base = P.philox_plain(7, *t(3, 6), 0, 4096)
    # the same key and counters: the same numbers, whatever came before
    P.philox_plain(8, *t(1, 1), 0, 100)
    assert torch.equal(base, P.philox_plain(7, *t(3, 6), 0, 4096))
    # a row's draw does not depend on n
    assert torch.equal(base[:1001], P.philox_plain(7, *t(3, 6), 0, 1001))
    for other in (P.philox_plain(8, *t(3, 6), 0, 4096),
                  P.philox_plain(7, *t(4, 6), 0, 4096),
                  P.philox_plain(7, *t(3, 7), 0, 4096),
                  P.philox_plain(7, *t(3, 6), 1, 4096)):
        assert (other != base).float().mean() > 0.99
    assert 0.0 <= float(base.min()) and float(base.max()) < 1.0


def test_keyed_view_counts_calls_and_reads_it_as_it_is_when_drawn():
    src = DrawSource(21)
    solve, it = t(4, 0)
    view = src.keyed(solve, it)
    assert isinstance(view, KeyedDraws)
    a, b = view.uniform("x", 64), view.uniform("x", 64)
    assert torch.equal(a, P.philox_plain(21, solve, it, 0, 64))
    assert torch.equal(b, P.philox_plain(21, solve, it, 1, 64))
    it.add_(3)  # the loop moved on: a new pass draws anew
    c = src.keyed(solve, it).uniform("x", 64)
    assert torch.equal(c, P.philox_plain(21, solve, it, 0, 64))
    prio = src.keyed(solve, it).prio15("x", 64)
    assert torch.equal(prio, (c * 32768).to(torch.int64))
    assert int(prio.max()) < 2 ** 15
    assert [src.next_solve() for _ in range(3)] == [0, 1, 2]


@pytest.mark.parametrize("prob", [0.3, 0.9])
def test_kept_share_within_a_binomial_bound(prob):
    """A RandomSamplingDataPointsFilter on keyed draws keeps each point with
    probability ``prob``: over 49,152 points the kept share lies within six
    standard deviations of it, for every one of 12 (solve, it) keys."""
    n = 49_152
    chain = FilterChain.from_yaml(
        [{"RandomSamplingDataPointsFilter": {"prob": prob}}])
    batch = nt.PointBatch.from_numpy(np.zeros((n, 3), np.float32),
                                     device="cpu")
    sd = np.sqrt(prob * (1 - prob) / n)
    src = DrawSource(3)
    for solve in range(3):
        for it in (0, 3, 6, 9):
            kept = chain.apply(batch, src.keyed(*t(solve, it))).mask
            assert abs(float(kept.float().mean()) - prob) < 6 * sd


def test_injected_source_with_step_filters_is_refused_on_a_card():
    """On a CUDA device the step filters draw keyed on the card; a source
    that the host must ask at every pass raises before any launch."""
    chain = FilterChain.from_yaml(
        [{"RandomSamplingDataPointsFilter": {"prob": 0.5}}])
    draws = DrawSource(0, "cpu", lambda site, n: torch.rand(n))
    with pytest.raises(ValueError, match="only on the CPU"):
        engine._refuse_source_on_card(chain, draws, torch.device("cuda"))
    # the CPU, no step chain, or a keyed source: accepted
    engine._refuse_source_on_card(chain, draws, torch.device("cpu"))
    engine._refuse_source_on_card(None, draws, torch.device("cuda"))
    engine._refuse_source_on_card(chain, DrawSource(0),
                                  torch.device("cuda"))


def test_wrapper_on_the_cpu_is_the_plain_version_and_checks_inputs():
    before = P.philox_uniform.launches
    assert torch.equal(P.philox_uniform(5, *t(1, 2), 0, 99),
                       P.philox_plain(5, *t(1, 2), 0, 99))
    assert P.philox_uniform.launches == before
    with pytest.raises(ValueError, match="int64"):
        P.philox_uniform(5, torch.tensor(1, dtype=torch.int32),
                         torch.tensor(2, dtype=torch.int32), 0, 9)
    with pytest.raises(ValueError, match="int32"):
        P.philox_uniform(5, torch.tensor(1), torch.tensor(2), 0, 9)


# ----------------------------------------------------------- the keep mask

def _keep_numpy(seed, solve, it, call, prob, mask, rows):
    u = philox_numpy(seed, solve, it, call, mask.shape[0])
    if rows is not None:
        u = u[rows]
    return mask & (u < np.float32(prob))


@pytest.mark.parametrize("prob", [0.0, 0.9, 1.0])
@pytest.mark.parametrize("n", [1, 3, 5, 1001, 4096])
@pytest.mark.parametrize("permuted", [False, True], ids=["rows_none",
                                                         "rows_permutation"])
def test_keep_plain_bit_for_bit_against_numpy(n, prob, permuted):
    rng = np.random.default_rng(n + int(prob * 10))
    mask = rng.random(n) > 0.2  # holes
    rows = rng.permutation(n).astype(np.int64) if permuted else None
    seed, solve, it, call = 2 ** 35 + 77, 6, 9, 1
    got = P.philox_keep_plain(seed, *t(solve, it), call, prob,
                              torch.from_numpy(mask),
                              None if rows is None else torch.from_numpy(rows))
    want = _keep_numpy(seed, solve, it, call, prob, mask, rows)
    assert got.dtype == torch.bool and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), want)
    if prob == 0.0:
        assert not got.any()
    if prob == 1.0:
        np.testing.assert_array_equal(got.numpy(), mask)


def test_keep_wrapper_on_the_cpu_is_the_plain_version_and_checks_inputs():
    mask = torch.ones(37, dtype=torch.bool)
    rows = torch.randperm(37, generator=torch.Generator().manual_seed(1))
    before = P.philox_keep.launches
    assert torch.equal(P.philox_keep(5, *t(1, 2), 0, 0.5, mask, rows),
                       P.philox_keep_plain(5, *t(1, 2), 0, 0.5, mask, rows))
    assert P.philox_keep.launches == before
    with pytest.raises(ValueError, match="bool"):
        P.philox_keep(5, *t(1, 2), 0, 0.5, mask.to(torch.uint8))
    with pytest.raises(ValueError, match="int64"):
        P.philox_keep(5, *t(1, 2), 0, 0.5, mask, rows.to(torch.int32))
    with pytest.raises(ValueError, match="shaped"):
        P.philox_keep(5, *t(1, 2), 0, 0.5, mask, rows[:5])


def test_keep_of_both_sources_is_their_uniforms_compared():
    """``KeyedDraws.keep`` draws the words ``uniform`` would, under its
    next call index; ``DrawSource.keep`` compares its own uniforms,
    gathered by ``rows``: the permuted form of every earlier PR."""
    n = 203
    mask = torch.from_numpy(np.random.default_rng(0).random(n) > 0.3)
    rows = torch.randperm(n, generator=torch.Generator().manual_seed(2))
    prob = torch.full((), 0.7, dtype=torch.float32)
    view = DrawSource(21).keyed(*t(4, 3))
    a, b = view.keep("x", 0.7, mask, rows), view.keep("x", 0.7, mask)
    solve, it = t(4, 3)
    assert torch.equal(a, mask & (P.philox_plain(21, solve, it, 0, n)[rows]
                                  < prob))
    assert torch.equal(b, mask & (P.philox_plain(21, solve, it, 1, n)
                                  < prob))
    u = torch.rand(n, generator=torch.Generator().manual_seed(9))
    src = DrawSource(0, "cpu", lambda site, m: u.clone())
    assert torch.equal(src.keep("x", 0.7, mask, rows),
                       mask & (u[rows] < prob))
    gen = DrawSource(8)
    want = mask & (DrawSource(8).uniform("x", n) < prob)
    assert torch.equal(gen.keep("x", 0.7, mask), want)


# ------------------------------------------------------ the solve's step chain

RS = {"RandomSamplingDataPointsFilter": {"prob": 0.7}}
BOX = {"BoundingBoxDataPointsFilter": {
    "xMin": -2.0, "xMax": 3.0, "yMin": -9, "yMax": 9, "zMin": -9, "zMax": 9,
    "removeInside": 1}}
MAXD = {"MaxDistDataPointsFilter": {"maxDist": 9.0}}
MIND = {"MinDistDataPointsFilter": {"minDist": 1.5}}
ROW_LOCAL_CHAINS = {"rs": [RS], "box_rs": [BOX, RS],
                    "rs_rs": [RS, {"RandomSamplingDataPointsFilter": {
                        "prob": 0.5}}],
                    "maxdist_rs_mindist": [MAXD, RS, MIND]}
PERMUTING_CHAINS = {
    "maxpointcount": [RS, {"MaxPointCountDataPointsFilter": {
        "maxCount": 300}}],
    "voxel_centroid": [{"VoxelGridDataPointsFilter": {
        "vSizeX": 1.0, "vSizeY": 1.0, "vSizeZ": 1.0, "useCentroid": 1}}, RS]}


def _reading(n=900, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    mask = rng.random(n) > 0.1
    return torch.from_numpy(pos), torch.from_numpy(mask)


def _loop(chain, max_dist, draws):
    pos, mask = _reading()
    solve = torch.tensor(3, dtype=torch.int64)
    loop = engine._Loop(pos, mask, pos, pos, mask, None, dim=3, k=1,
                        max_dist=max_dist, outlier_filters=(),
                        minimizer="PointToPlaneErrorMinimizer", max_iter=10,
                        diff_checker=None, step_filters=chain, draws=draws,
                        solve_index=solve)
    loop.start()
    loop.it.fill_(6)  # the pass at it = 6 draws its own numbers
    T = se3.exp_se3(torch.tensor([0.3, -0.2, 0.1, 0.02, -0.01, 0.03]))
    return loop, se3.apply_points(T, loop.read)


def _sources():
    u = torch.rand(900, generator=torch.Generator().manual_seed(4))
    return {"keyed": DrawSource(11),
            "source": DrawSource(0, "cpu", lambda site, n: u.clone())}


@pytest.mark.parametrize("draws", ["keyed", "source"])
@pytest.mark.parametrize("max_dist", [1.0, float("inf")],
                         ids=["sorted", "unsorted"])
@pytest.mark.parametrize("name", list(ROW_LOCAL_CHAINS))
def test_row_order_step_chain_equals_the_permuted_one(name, max_dist, draws):
    """A row-local chain in the solve's order with ``rows=order``: the
    same positions (unmoved, the very tensor) and mask bits as the chain on
    the reading permuted back to its original order, and no inverse built;
    two drawing filters draw under call indices 0 and 1 alike."""
    chain = FilterChain.from_yaml(ROW_LOCAL_CHAINS[name])
    assert chain.row_local
    loop, p = _loop(chain, max_dist, _sources()[draws])
    assert (loop.order is None) == (max_dist == float("inf"))
    assert loop.inv_order is None
    pos_r, mask_r = loop._stepped(p, loop.mask)
    assert pos_r is p
    pos_p, mask_p = loop._stepped_permuted(p, loop.mask)
    assert torch.equal(pos_p, p)
    assert torch.equal(mask_r, mask_p)
    # the draws really thin the reading, and only where it was valid
    assert 0 < int(mask_r.sum()) < int(loop.mask.sum())
    assert not bool((mask_r & ~loop.mask).any())


@pytest.mark.parametrize("name", list(PERMUTING_CHAINS))
def test_chains_that_are_not_row_local_keep_the_permute_path(name):
    """MaxPointCount (a count in row order) and VoxelGrid's centroids are
    not row-local: the solve builds the inverse of its sort, filters the
    reading permuted back and permutes mask and positions forward -- the
    result of the earlier design, written out here -- and the chain refuses
    ``rows``."""
    chain = FilterChain.from_yaml(PERMUTING_CHAINS[name])
    assert not chain.row_local
    loop, p = _loop(chain, 1.0, DrawSource(11))
    order = loop.order
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0])
    assert torch.equal(loop.inv_order, inv)
    draws = DrawSource(11).keyed(loop.solve_index, loop.it)
    want = chain._apply_impl(PointBatch(p[inv], loop.mask[inv], {}), draws)
    pos, mask = loop._stepped(p, loop.mask)
    assert torch.equal(pos, want.positions[order])
    assert torch.equal(mask, want.mask[order])
    if name == "voxel_centroid":
        assert not torch.equal(pos, p)  # the centroids moved points
    with pytest.raises(ValueError, match="not row-local"):
        chain._apply_impl(PointBatch(p, loop.mask, {}), draws, rows=order)


@pytest.mark.parametrize("name", ["box_rs", "maxpointcount"])
def test_sharded_step_mask_both_paths_equal(name):
    """The sharded ``_step_mask``: a row-local chain in the solve's order
    (``rows=order``, no inverse from ``_matcher``), any other chain on the
    reading permuted back through the inverse ``_matcher`` built once per
    solve; each equal bit for bit to the earlier design's mask, written out
    here (the inverse rebuilt, the reading permuted back, the mask
    forward)."""
    chain = FilterChain.from_yaml({**ROW_LOCAL_CHAINS,
                                   **PERMUTING_CHAINS}[name])
    step = ShardedMapperStep.__new__(ShardedMapperStep)
    step.cfg = ShardedMapConfig(match_max_dist=1.0,
                                step_filter=chain._apply_impl)
    pos, mask = _reading(seed=1)
    _, read, rmask, order, inv = step._matcher(pos, mask, pos, mask)
    assert (inv is None) == chain.row_local
    inv_want = torch.empty_like(order)
    inv_want[order] = torch.arange(order.shape[0])
    if inv is not None:
        assert torch.equal(inv, inv_want)
    p = read + torch.tensor([0.2, -0.1, 0.05])
    keyed = DrawSource(5).keyed(*t(2, 3))
    got = step._step_mask(p, rmask, keyed, order, inv)
    want = rmask & chain._apply_impl(
        PointBatch(p[inv_want], rmask[inv_want], {}),
        DrawSource(5).keyed(*t(2, 3))).mask[order]
    assert torch.equal(got, want)
    permuted = step._step_mask_permuted(p, rmask, DrawSource(5).keyed(
        *t(2, 3)), order, inv_want)
    assert torch.equal(permuted, want)
    assert 0 < int(got.sum()) < int(rmask.sum())
