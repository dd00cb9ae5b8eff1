"""The steps the redesigned pair loop added around the kernels, on the CPU:
the packed reference layouts, the list of valid queries, the cut of the
references into ranges (of a window into chunks) with the merge of the
partial lists, and the self-search through one pack.

Everything here is exact: the same f32 operations in the same order on both
sides, so distances are compared bit for bit and every index must be equal
(the tie rule -- lower index first -- decides among equal distances).
"""
import numpy as np
import pytest
import torch

from norlab_icp_mapper_tpu_torch.ops import nn as tnn
from norlab_icp_mapper_tpu_torch.ops import nn_sweep as ts


def _t(x):
    return None if x is None else torch.from_numpy(np.asarray(x))


def _cloud(seed, n, m, dim, dup_at=()):
    rng = np.random.default_rng(seed)
    q = (rng.normal(size=(n, dim)) * 4).astype(np.float32)
    r = (rng.normal(size=(m, dim)) * 4).astype(np.float32)
    for lo, hi in dup_at:  # r[hi] repeats r[lo]: an exact tie for any query
        r[hi] = r[lo]
    qm = rng.random(n) > 0.25
    rm = rng.random(m) > 0.25
    return q, r, qm, rm


def _range_borders(m_valid, splits):
    per = -(-m_valid // splits)
    per = -(-per // 16) * 16
    return [min(m_valid, s * per) for s in range(splits + 1)]


# ---------------------------------------------------------------- (a) merge

@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k", [1, 3, 10, 32])
@pytest.mark.parametrize("splits", [1, 2, 3, 4, 8])
def test_ranges_merged_equal_the_whole(splits, k, dim):
    """References cut into S ascending ranges, ``knn_plain`` on each, merged:
    equal to ``knn_plain`` on the whole, bit for bit in d2 and in every
    index.  Ragged sizes; duplicates planted on both sides of every range
    border, so that the lower index must win across a border."""
    q, r, qm, rm = _cloud(100 + 10 * k + dim, 93, 421, dim)
    rm[:] = True
    borders = _range_borders(421, splits)
    for b in borders[1:-1]:
        if 2 <= b < 420:
            r[b] = r[b - 1]      # twins astride the border
            r[b + 1] = r[b - 2]  # and a pair that straddles it further out
    whole_d, whole_i = tnn.knn_plain(_t(q), _t(r), _t(qm), None, k=k)
    parts = []
    for lo, hi in zip(borders, borders[1:]):
        d, i = tnn.knn_plain(_t(q), _t(r[lo:hi]), _t(qm), None, k=k)
        parts.append((d, torch.where(i >= 0, i + lo, i)))
    d, i = tnn.merge_ranges_plain(parts, k)
    assert torch.equal(d, whole_d) and torch.equal(i, whole_i)
    # the schedule as a whole (pack, list, ranges, merge, rows)
    d, i = tnn.knn_schedule_plain(_t(q), _t(qm), tnn.pack_refs(_t(r), None),
                                  k, splits)
    assert torch.equal(d, whole_d) and torch.equal(i, whole_i)


@pytest.mark.parametrize("k", [1, 4, 10])
@pytest.mark.parametrize("n_valid_ref", [0, 1, 7, 40])
def test_ranges_with_few_or_no_references(n_valid_ref, k):
    """A range with fewer than k valid references, ranges that are empty
    (8 ranges over 7 references, or over none at all)."""
    q, r, qm, rm = _cloud(7 + k, 50, 200, 3)
    rm[:] = False
    rm[np.linspace(3, 190, n_valid_ref).astype(int)] = True
    whole_d, whole_i = tnn.knn_plain(_t(q), _t(r), _t(qm), _t(rm), k=k)
    pack = tnn.pack_refs(_t(r), _t(rm))
    for splits in (1, 2, 8):
        d, i = tnn.knn_schedule_plain(_t(q), _t(qm), pack, k, splits)
        assert torch.equal(d, whole_d) and torch.equal(i, whole_i)


def test_merge_prefers_the_lower_range_and_the_earlier_entry():
    inf = float("inf")
    a = (torch.tensor([[1.0, 2.0, 2.0]]), torch.tensor([[4, 5, 9]]))
    b = (torch.tensor([[1.0, 2.0, inf]]), torch.tensor([[20, 21, -1]]))
    d, i = tnn.merge_ranges_plain([a, b], 4)
    assert d.tolist() == [[1.0, 1.0, 2.0, 2.0]]
    assert i.tolist() == [[4, 20, 5, 9]]
    d, i = tnn.merge_ranges_plain([a, b], 6)
    assert i.tolist() == [[4, 20, 5, 9, 21, -1]] and d[0, 5] == inf


# ---------------------------------------------------------------- (c) packs

@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_pack_refs_layout(dim, masked):
    """``f32[M, 4]``: coordinates exact, z = 0 at D = 2, the original index
    as the bits of the fourth lane, valid references in front, order kept."""
    rng = np.random.default_rng(dim)
    r = rng.normal(size=(137, dim)).astype(np.float32)
    rm = rng.random(137) > 0.4 if masked else None
    pack = tnn.pack_refs(_t(r), _t(rm))
    assert pack.ref4.shape == (137, 4) and pack.ref4.dtype == torch.float32
    assert pack.ref4.is_contiguous() and pack.dim == dim
    n = int(pack.n_valid)
    ids = pack.ref4.numpy().view(np.int32)[:, 3]
    want = np.nonzero(rm)[0] if masked else np.arange(137)
    assert n == len(want)
    np.testing.assert_array_equal(ids[:n], want)
    np.testing.assert_array_equal(pack.ref4.numpy()[:n, :dim], r[want])
    if dim == 2:
        assert (pack.ref4.numpy()[:, 2] == 0).all()
    # every row is there exactly once (the invalid ones behind the count)
    np.testing.assert_array_equal(np.sort(ids), np.arange(137))
    np.testing.assert_array_equal(pack.ids.numpy(), ids)
    np.testing.assert_array_equal(pack.ref_c.numpy(), pack.ref4.numpy()[:, :dim])


@pytest.mark.parametrize("index", [0, 1, 2 ** 23, 2 ** 24 - 1, 2 ** 24,
                                   2 ** 24 + 1, 2 ** 30 + 12345, 2 ** 31 - 1])
def test_index_bits_survive_the_float_lane(index):
    """An int32 viewed as float32 is a denormal, an ordinary number or a NaN
    pattern; indexing, copying and concatenating must leave its bits alone
    (above 2^24 a conversion to float would already lose the index)."""
    lane = torch.tensor([index, 7, index], dtype=torch.int32)
    ref4 = torch.zeros((3, 4), dtype=torch.float32)
    ref4.view(torch.int32)[:, 3] = lane
    moved = torch.cat([ref4[[2, 0, 1]].clone(), ref4])[::2].contiguous()
    back = moved.view(torch.int32)[:, 3]
    assert back.tolist() == [index, 7, 7]


@pytest.mark.parametrize("dim", [2, 3])
def test_presort_ref_layout(dim):
    """The sweep's pack: ``f32[M, 4]`` in ascending-x order, centred, the
    sorted position's original index in the fourth lane."""
    rng = np.random.default_rng(20 + dim)
    r = rng.uniform(-9, 9, size=(211, dim)).astype(np.float32)
    rm = rng.random(211) > 0.3
    pack = ts.presort_ref(_t(r), _t(rm))
    n = int(pack.n_valid)
    assert n == rm.sum()
    assert pack.ref_s.shape == (211, 4) and pack.ref_s.is_contiguous()
    ids = pack.ref_s.numpy().view(np.int32)[:, 3]
    np.testing.assert_array_equal(ids, pack.ref_order.numpy())
    np.testing.assert_array_equal(np.sort(ids), np.arange(211))
    assert rm[ids[:n]].all() and not rm[ids[n:]].any()
    centred = r - pack.center.numpy()
    np.testing.assert_array_equal(pack.ref_s.numpy()[:, :dim], centred[ids])
    xs = pack.ref_s.numpy()[:n, 0]
    assert (np.diff(xs) >= 0).all()
    np.testing.assert_array_equal(pack.ref_xs.numpy()[:n], xs)
    # equal x keeps the input order (stable sort): the tie rule's base
    if dim == 2:
        assert (pack.ref_s.numpy()[:, 2] == 0).all()


# ------------------------------------------------------ (d) valid-query list

@pytest.mark.parametrize("frac", [0.0, 0.3, 1.0])
def test_valid_first_and_query_rows(frac):
    rng = np.random.default_rng(5)
    mask = rng.random(301) < frac
    order, count = tnn.valid_first(_t(mask))
    assert int(count) == mask.sum() and count.dtype == torch.int64
    n = int(count)
    np.testing.assert_array_equal(order[:n].numpy(), np.nonzero(mask)[0])
    np.testing.assert_array_equal(order[n:].numpy(), np.nonzero(~mask)[0])
    rows, cnt = tnn.query_rows(_t(mask))
    assert rows.dtype == torch.int32 and int(cnt) == n
    np.testing.assert_array_equal(rows.numpy(), order.numpy())
    assert tnn.query_rows(None) is None


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("n_valid_q", [0, 1, 64])
def test_results_land_on_the_queries_own_rows(n_valid_q, k, dim):
    q, r, qm, rm = _cloud(40 + k, 90, 150, dim)
    qm[:] = False
    qm[np.random.default_rng(1).choice(90, n_valid_q, replace=False)] = True
    want_d, want_i = tnn.knn_plain(_t(q), _t(r), _t(qm), _t(rm), k=k)
    d, i = tnn.knn_schedule_plain(_t(q), _t(qm), tnn.pack_refs(_t(r), _t(rm)),
                                  k, 4)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    assert bool(torch.isinf(d[~_t(qm)]).all()) and bool((i[~_t(qm)] == -1).all())
    assert bool(torch.isfinite(d[_t(qm)]).all())


# ---------------------------------------------------------- (e) self-search

@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("splits", [1, 2, 8])
def test_self_search_through_one_pack(splits, k, dim):
    """The pack's rows as queries and query list at once: equal to the
    general call with two packs, self-matches and twins included."""
    _, r, _, rm = _cloud(60 + k + dim, 5, 260, dim, dup_at=[(10, 200),
                                                            (11, 12)])
    pos, mask = _t(r), _t(rm)
    pack = tnn.pack_refs(pos, mask)
    want_d, want_i = tnn.knn_plain(pos, pos, mask, mask, k=k)
    d, i = tnn.knn_schedule_plain(pos, mask, pack, k, splits,
                                  self_search=True)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    d2, i2 = tnn.knn_schedule_plain(pos, mask, pack, k, splits)
    assert torch.equal(d2, want_d) and torch.equal(i2, want_i)
    # a valid point finds itself (or its lower twin) at distance 0
    assert bool((d[mask][:, 0] == 0).all())


@pytest.mark.parametrize("n,k,want", [
    (49_152, 1, 8), (163_840, 10, 2), (49_152, 10, 8), (1_000_000, 1, 1),
    (300, 32, 8), (0, 1, 8)])
def test_pick_splits(n, k, want):
    """A host-side integer from N and k alone: the smallest power of two up
    to 8 that fills the card (8 warps a scheduler)."""
    assert tnn.pick_splits(n, k) == want


# ------------------------------------------------- (b) the sweep's chunks

def _sorted_sweep_inputs(seed, n, m, dim, radius, block, twins=True):
    """Sorted, padded queries and the sweep's windows per block of ``block``
    queries, on a cloud whose every reference is stored twice (twins are
    neighbours in the sorted order, so chunk borders split many of them)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-6, 6, size=(m // 2, dim)).astype(np.float32)
    r = np.concatenate([base, base]) if twins else \
        rng.uniform(-6, 6, size=(m, dim)).astype(np.float32)
    q = rng.uniform(-6, 6, size=(n, dim)).astype(np.float32)
    qm, rm = rng.random(n) > 0.2, rng.random(len(r)) > 0.1
    pack = ts.presort_ref(_t(r), _t(rm))
    qc = _t(q) - pack.center
    order, _ = ts.presort_queries(qc, _t(qm))
    pad = -(-n // block) * block - n
    q_s = ts.pad_rows(qc[order], pad, ts.BIG)
    qm_s = ts.pad_rows(_t(qm)[order], pad, False)
    qx_s = torch.where(qm_s, q_s[:, 0], torch.full_like(q_s[:, 0], ts.BIG))
    W = len(r)
    _, _, _, ov, b_start, b_end = ts.sweep_windows(
        qx_s, qm_s, pack, torch.tensor(radius), block, W, block)
    assert int(ov) == 0
    return q_s, qm_s, pack, b_start, b_end


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("k", [1, 3, 6])
@pytest.mark.parametrize("chunks,chunk", [(1, 4096), (2, 48), (4, 16),
                                          (8, 16), (4, 2048)])
def test_chunks_merged_equal_the_window(chunks, chunk, k, dim):
    """``_search_plain`` per chunk of a window, merged, equals
    ``_search_plain`` on the window bit for bit in d2 and in every position:
    ties across chunk borders (twins), windows longer than all chunks
    together are cut alike on both sides, windows shorter than one chunk
    leave the later chunks empty."""
    radius = 1.5
    r2 = float(np.float32(radius) * np.float32(radius))
    q_s, qm_s, pack, b_start, b_end = _sorted_sweep_inputs(
        3 + k + dim, 500, 700, dim, radius, 256)
    # a window is at most chunks * chunk long (the wrapper's W)
    b_end = torch.minimum(b_end, b_start + chunks * chunk)
    live = torch.ones_like(b_start, dtype=torch.bool)
    want_d, want_i = ts._search_plain(q_s, qm_s, pack.ref_s, b_start, b_end,
                                      live, r2, k, 256)
    d, i = ts.search_chunked_plain(q_s, qm_s, pack.ref_s, b_start, b_end, r2,
                                   k, 256, chunks, chunk)
    assert torch.equal(d, want_d) and torch.equal(i, want_i)
    spans = (b_end - b_start)
    if chunk == 2048:
        assert int(spans.max()) < chunk  # shorter than one chunk
    elif chunks > 1:
        assert int(spans.max()) > chunk  # really cut
        # twins were found on both sides of a border: some query has two
        # equal finite distances in a row
        if k > 1:
            fin = torch.isfinite(want_d[:, 1])
            assert bool((want_d[:, 0] == want_d[:, 1])[fin].any())


@pytest.mark.parametrize("W,want", [(8192, (4, 2048)), (1024, (1, 1024)),
                                    (2048, (1, 2048)), (3000, (2, 1504)),
                                    (100_000, (8, 12512)), (1, (1, 16)),
                                    (2049, (2, 1040))])
def test_chunking(W, want):
    """The fewest chunks (a power of two up to 8) of at most 2,048
    references, each a multiple of 16, that together cover ``W``."""
    chunks, chunk = ts.chunking(W)
    assert (chunks, chunk) == want
    assert chunks * chunk >= W and chunk % 16 == 0
