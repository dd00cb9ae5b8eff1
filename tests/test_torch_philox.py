"""``ops/philox.py`` and the keyed step-filter draws on the CPU.

``philox_plain`` (the arithmetic of ``csrc/philox.cu``, int64 with 16-bit
split products) is held bit for bit against Philox4x32-10 written here in
numpy with uint64 products, which are exact for 32-bit operands.  The draws
depend on (seed, solve index, ``it``, row, call) alone; a random step filter
keeps a share of the points within a binomial bound of ``prob``; and a
caller-supplied draw source is refused for step filters on a CUDA device
(the refusal needs no card: it is decided before anything is launched)."""
import numpy as np
import pytest
import torch

import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch.draws import DrawSource, KeyedDraws
from norlab_icp_mapper_tpu_torch.filters.core import FilterChain
from norlab_icp_mapper_tpu_torch.icp import engine
from norlab_icp_mapper_tpu_torch.ops import philox as P

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
