"""Nearest-neighbour search without a radius: brute force over all pairs.

The reference delegates k-NN to libnabo kd-trees; pointer-chasing trees map
poorly to wide vector hardware, so this module searches by brute force: the
[N, M] squared-distance matrix is never materialised -- the references
stream past every query while a running top-k per query is kept.

Semantics mirror libnabo: squared distances, ``inf`` + index ``-1`` for no
match (beyond ``max_radius``, masked, or fewer than k references),
self-matches allowed.  Rows come back ascending; among equal distances the
lower reference index comes first.

The kernel
----------
On a CUDA tensor ``knn`` launches ``csrc/knn_brute.cu``, written by hand for
Hopper; it replaces the Pallas TPU kernel ``_kernel`` (``ops/nn_pallas.py``
of the JAX package, launched by ``_knn_planar`` and wrapped by
``knn_pallas``).

* What bounds it on an H100: operations, and among them instruction dispatch.
  A pair costs 3 subtractions, 3 products and 2 sums in f32, each rounded on
  its own (so that the kernel agrees with the plain version bit for bit),
  plus its ranking; a scheduler dispatches one instruction per clock, so the
  card cannot pass lanes x clock / (instructions per pair).  Every query and
  reference is read once, ``12 k`` bytes are written per query: bytes are
  far below that.
* What the design does about it.  References are packed as ``f32[M, 4]``
  (x, y, z, the bits of the original index; valid ones in front, their count
  on the device: :func:`pack_refs`), so a staged reference is one 128-bit
  load and no index is gathered at the end.  A thread holds several queries
  in registers and uses every loaded reference for all of them.  Only valid
  queries get a thread (:func:`valid_first` lists them without a host read;
  a cloud searched against itself reads its queries from the pack).  The
  references are cut into ``S`` ascending ranges searched by the ``S``
  blocks of a thread-block cluster and merged in distributed shared memory
  (:func:`pick_splits` chooses ``S`` on the host from N and k alone).  Tiles
  arrive by ``cp.async`` in a two-deep ring.  At k = 1 the loop keeps a
  running minimum and recovers the index afterwards; at k > 1 the sorted
  insertion runs only for a group of references that holds a candidate, and
  a cloud searched against itself first takes the k-th distance among the
  block's own stretch of the array as a gate, because points in scan order
  would otherwise refill every list at each approach of the scan.
* Tensor cores are not used: the product has a depth of 3, and the expanded
  form ``|q|^2 + |r|^2 - 2 q.r`` in TF32 (or split three ways) loses the
  digits that the tie rule, PointDistance's 0.15 m gate and bit-identity
  with the plain version need at coordinates of tens of metres.
* Differences from the TPU kernel, all deliberate: the distance is
  subtract-first exact f32 (the TPU kernel ranks by ``|r|^2 - 2 q.r`` from a
  matrix product, whose rounding error grows as ``eps * |x|^2``); no planar
  ``[8, N]`` layout and no 1e9 sentinel coordinates; nothing is padded to
  1024; ties go to the lower index; ``k`` is at most ``MAX_K`` and a larger
  one raises.

On a CPU tensor ``knn`` runs :func:`knn_plain`, the same function in
ordinary tensor operations, which the tests and the on-card comparison use
on any device.  A CUDA tensor never takes it from ``knn``: the kernel
launches or the call raises.  :func:`knn_schedule_plain` walks the kernel's
schedule (pack, query list, ranges, merge) in ordinary tensor operations;
the tests and the on-card comparison hold it against :func:`knn_plain`.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .nn_sweep import (_KERNEL_BLOCK, _check_kernel_args, _pair_d2,
                       merge_ranges_plain, pack_rows4)

__all__ = ["knn", "nn1", "radius_knn", "knn_plain", "pack_refs", "KnnPack",
           "MAX_K", "valid_first", "query_rows", "pick_splits",
           "merge_ranges_plain", "knn_schedule_plain"]

MAX_K = 32  # largest register list of the kernel
_PLAIN_Q_CHUNK = 16384  # queries per chunk of the plain version
# list buckets of the kernel and the queries a thread holds in each
_QUERIES_PER_THREAD = {1: 4, 4: 2, 8: 2, 12: 2, 16: 1, 32: 1}
_MAX_SPLITS = 8  # blocks per cluster
# warps the grid should hold: 8 for each of the card's 132 x 4 schedulers
_TARGET_WARPS = 8 * 132 * 4


class KnnPack(NamedTuple):
    """The references as the kernel reads them, built by :func:`pack_refs`
    once per change of the reference cloud."""
    ref4: torch.Tensor  # f32[M, 4] x, y, z (0 at D=2), bits of the index
    n_valid: torch.Tensor  # 0-d i64, on the refs' device
    dim: int  # D of the cloud that was packed

    @property
    def ref_c(self) -> torch.Tensor:
        """f32[M, D]: valid refs first, original order kept."""
        return self.ref4[:, :self.dim]

    @property
    def ids(self) -> torch.Tensor:
        """i32[M]: packed position -> original index (the fourth lane's
        bits)."""
        return self.ref4.view(torch.int32)[:, 3]


def valid_first(mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rows with the valid ones in front, order kept on both sides (a stable
    sort of the mask), and the count of valid rows as a 0-d i64 tensor.
    Nothing is read back to the host."""
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    return order, mask.sum()


def pack_refs(ref: torch.Tensor, ref_mask: Optional[torch.Tensor]) -> KnnPack:
    """Valid references to the front (:func:`valid_first`: the original
    order -- and with it the tie rule -- is kept), four floats a reference:
    the coordinates, then the original index as the bits of an int32.  The
    fourth lane is only ever copied, never computed with."""
    m, dim = ref.shape
    if ref_mask is None:
        order = torch.arange(m, dtype=torch.int32, device=ref.device)
        n_valid = torch.full((), m, dtype=torch.int64, device=ref.device)
        return KnnPack(pack_rows4(ref, order), n_valid, dim)
    order, n_valid = valid_first(ref_mask)
    return KnnPack(pack_rows4(ref[order], order), n_valid, dim)


def _bucket(k: int) -> int:
    return next(b for b in _QUERIES_PER_THREAD if k <= b)


def pick_splits(n: int, k: int) -> int:
    """Ranges the references are cut into (= blocks per cluster): the
    smallest of 1, 2, 4, 8 that gives the grid ``_TARGET_WARPS`` warps, from
    the number of query rows and k alone."""
    per_block = _KERNEL_BLOCK * _QUERIES_PER_THREAD[_bucket(k)]
    warps = -(-max(n, 1) // per_block) * (_KERNEL_BLOCK // 32)
    s = 1
    while s < _MAX_SPLITS and warps * s < _TARGET_WARPS:
        s *= 2
    return s


def query_rows(query_mask: Optional[torch.Tensor]):
    """What the kernel takes in place of a query mask: ``(rows i32[N],
    count 0-d i64)`` with the valid rows in front (:func:`valid_first`), or
    None when every query is valid."""
    if query_mask is None:
        return None
    order, count = valid_first(query_mask)
    return order.to(torch.int32), count


def _knn_kernel(query, qrows, pack: KnnPack, k: int,
                self_search: bool = False, splits: Optional[int] = None,
                out=None):
    """Launch ``csrc/knn_brute.cu`` on the current stream.  ``qrows`` is
    :func:`query_rows` of the query mask.  With ``self_search`` the pack's
    rows are the queries and ``qrows`` is not read (``query`` is the cloud
    the pack was built from).  With ``out = (d2, idx)`` the kernel searches
    only the rows that ``qrows`` lists before its count, writes their
    results into ``out`` and touches no other row (the grid search's
    fallback, ``ops/nn_grid.py``)."""
    from ._build import load
    n, dim = query.shape
    if dim not in (2, 3):
        raise ValueError(f"knn kernel supports D in (2, 3); got D={dim}")
    if query.dtype != torch.float32 or pack.ref4.dtype != torch.float32:
        raise ValueError("knn kernel needs float32 coordinates")
    if pack.dim != dim:
        raise ValueError("knn kernel: queries and references differ in D")
    if (pack.ref4.ndim != 2 or pack.ref4.shape[1] != 4
            or pack.n_valid.dtype != torch.int64):
        raise ValueError("knn kernel: the reference pack is f32[M, 4] with "
                         "an int64 count")
    if self_search and pack.ref4.shape[0] != n:
        raise ValueError("knn kernel: a self-search needs the pack of the "
                         "queries' own cloud")
    if splits is None:
        splits = pick_splits(n, k)
    tensors = [query, pack.ref4, pack.n_valid]
    qlist = n_q = None
    if self_search:
        q_src, q_stride, n_q = pack.ref4, 4, pack.n_valid
    else:
        q_src, q_stride = query, dim
        if qrows is not None:
            qlist, n_q = qrows
            if (qlist.dtype != torch.int32 or n_q.dtype != torch.int64
                    or qlist.shape != (n,)):
                raise ValueError("knn kernel: the query rows are i32[N] "
                                 "with an int64 count")
            tensors += [qlist, n_q]
    if out is not None:
        tensors += list(out)
        if (qrows is None or self_search or out[0].shape != (n, k)
                or out[1].shape != (n, k) or out[0].dtype != torch.float32
                or out[1].dtype != torch.int64):
            raise ValueError("knn kernel: a listed search needs the rows' "
                             "list and f32 / i64 outputs of [N, k]")
        d_out, i_out = out
    else:
        d_out = torch.empty((n, k), dtype=torch.float32, device=query.device)
        i_out = torch.empty((n, k), dtype=torch.int64, device=query.device)
    _check_kernel_args(*tensors)
    if n == 0:
        return d_out, i_out  # no query, no launch
    ref4 = pack.ref4
    if ref4.shape[0] == 0:
        # never read (the count is 0), but the pointer must be valid
        ref4 = query.new_zeros((1, 4))
    lib = load("knn_brute")
    fn = lib.knn_brute_launch
    if not getattr(fn, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, ci, vp, vp, vp, ci, ci, ci, ci, ci, vp, vp,
                       vp]
        fn.restype = ci
        fn._typed = True
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q_src.data_ptr(), q_stride,
                 None if qlist is None else qlist.data_ptr(),
                 int(self_search), None if n_q is None else n_q.data_ptr(),
                 ref4.data_ptr(), pack.n_valid.data_ptr(), n, dim, k, splits,
                 int(out is not None), d_out.data_ptr(), i_out.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"knn_brute kernel launch failed (code {err})")
    knn.launches += 1
    key = (dim, k)
    knn.launches_by_shape[key] = knn.launches_by_shape.get(key, 0) + 1
    return d_out, i_out


def _topk_plain(query, ref, query_mask, ref_mask, k: int, ref_tile: int):
    """The kernel's function in plain tensor operations: references in
    tiles of ``ref_tile``, subtract-first distances (``_pair_d2``), and per
    tile k rounds of (min, first argmin) over ``[running best | tile]``.
    ``torch.min`` returns the first minimal position, and the running best
    (earlier tiles, so lower indices) stands before the tile, so among equal
    distances the lower index wins -- no ``topk``, which promises no order
    among ties."""
    n = query.shape[0]
    m = ref.shape[0]
    dev = query.device
    inf = float("inf")
    best_d = torch.full((n, k), inf, dtype=torch.float32, device=dev)
    best_i = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    for s0 in range(0, m, ref_tile):
        e0 = min(m, s0 + ref_tile)
        d2 = _pair_d2(query, ref[s0:e0])
        if ref_mask is not None:
            d2 = torch.where(ref_mask[None, s0:e0], d2,
                             torch.full_like(d2, inf))
        cat_d = torch.cat([best_d, d2], dim=1)
        gidx = torch.arange(s0, e0, dtype=torch.int64, device=dev)
        cat_i = torch.cat([best_i, gidx[None, :].expand(n, -1)], dim=1)
        for j in range(k):
            mval, a = cat_d.min(dim=1)
            best_d[:, j] = mval
            best_i[:, j] = torch.gather(cat_i, 1, a[:, None])[:, 0]
            if j + 1 < k:
                cat_d.scatter_(1, a[:, None], inf)
    found = torch.isfinite(best_d)
    if query_mask is not None:
        found = found & query_mask[:, None]
    best_d = torch.where(found, best_d, torch.full_like(best_d, inf))
    best_i = torch.where(found, best_i, torch.full_like(best_i, -1))
    return best_d, best_i


def _apply_radius(d2, idx, max_radius):
    """``d2 <= r^2`` on the k results, after the search; r^2 is rounded in
    f32 once, on the host."""
    r = np.float32(max_radius)
    ok = d2 <= float(r * r)
    return (torch.where(ok, d2, torch.full_like(d2, float("inf"))),
            torch.where(ok, idx, torch.full_like(idx, -1)))


def knn_plain(query, ref, query_mask=None, ref_mask=None, k: int = 1,
              max_radius: Optional[float] = None, ref_tile: int = 2048
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`knn` through the plain PyTorch version of the kernel, on
    whatever device the tensors lie (the yardstick of the comparison on the
    card; no speed is claimed for it).  Queries go in chunks so that the
    ``[chunk, ref_tile]`` intermediates stay small."""
    n = query.shape[0]
    outs_d, outs_i = [], []
    for q0 in range(0, max(n, 1), _PLAIN_Q_CHUNK):
        sl = slice(q0, min(n, q0 + _PLAIN_Q_CHUNK))
        d, i = _topk_plain(query[sl], ref,
                           None if query_mask is None else query_mask[sl],
                           ref_mask, k, ref_tile)
        outs_d.append(d)
        outs_i.append(i)
    d2, idx = torch.cat(outs_d), torch.cat(outs_i)
    if max_radius is not None:
        d2, idx = _apply_radius(d2, idx, max_radius)
    return d2, idx


def knn_schedule_plain(query, query_mask, pack: KnnPack, k: int, splits: int,
                       self_search: bool = False):
    """The kernel's schedule in plain tensor operations, on whatever device
    the tensors lie: the valid queries in list order (or the pack's own rows
    for a self-search) against each of ``splits`` ranges of the packed
    references, the partial lists merged by :func:`merge_ranges_plain`, the
    indices taken from the pack's fourth lane, every result on its query's
    own row and ``inf`` / ``-1`` on the others.  Reads the two counts to the
    host; for the tests and the on-card comparison only."""
    n = query.shape[0]
    dev = query.device
    m = int(pack.n_valid)
    if self_search:
        rows, n_q = pack.ids.to(torch.int64), m
        q_valid = pack.ref_c[:n_q]
    elif query_mask is None:
        rows, n_q = torch.arange(n, device=dev), n
        q_valid = query
    else:
        rows, count = valid_first(query_mask)
        n_q = int(count)
        q_valid = query[rows[:n_q]]
    per = -(-m // splits)
    per = -(-per // 16) * 16  # ranges start on a group of 16, as the kernel's
    parts = []
    for s in range(splits):
        r0, r1 = min(m, s * per), min(m, (s + 1) * per)
        d, pos = knn_plain(q_valid, pack.ref_c[r0:r1], k=k)
        if r1 > r0:  # (an empty range found nothing: pos is all -1)
            ids = pack.ids[r0:r1].to(torch.int64)
            pos = torch.where(pos >= 0, ids[torch.clamp(pos, min=0)], pos)
        parts.append((d, pos))
    d_v, i_v = merge_ranges_plain(parts, k)
    d_out = torch.full((n, k), float("inf"), dtype=torch.float32, device=dev)
    i_out = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    d_out[rows[:n_q]] = d_v
    i_out[rows[:n_q]] = i_v
    return d_out, i_out


def knn(
    query: torch.Tensor,  # f32[N, D]
    ref: torch.Tensor,  # f32[M, D]
    query_mask: Optional[torch.Tensor] = None,  # bool[N]
    ref_mask: Optional[torch.Tensor] = None,  # bool[M]
    k: int = 1,
    max_radius: Optional[float] = None,  # None = unbounded
    pack: Optional[KnnPack] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest reference points for every query point.

    Returns ``(dists2 f32[N, k], idx i64[N, k])`` ascending per query, ties
    by lowest index.  Masked-out queries, missing neighbours (fewer than k
    valid references) and out-of-radius results have ``dists2 = inf`` and
    ``idx = -1``.  ``max_radius`` is applied to the k results after the
    search.

    ``pack`` optionally supplies :func:`pack_refs`'s output for the same
    ``ref`` / ``ref_mask`` (a caller that searches one cloud many times
    builds it once).  A cloud searched against itself (``query is ref`` and
    ``query_mask is ref_mask``) reads its queries from the pack: one layout,
    one sort of the mask.  A CUDA ``query`` launches the hand-written kernel
    (or raises); a CPU ``query`` runs the plain version.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn supports 1 <= k <= {MAX_K}; got k={k}")
    if not query.is_cuda:
        return knn_plain(query, ref, query_mask, ref_mask, k, max_radius)
    if pack is None:
        pack = pack_refs(ref, ref_mask)
    self_search = query is ref and query_mask is ref_mask
    # the rows' memory may be reused as soon as the launch is queued: the
    # allocator reuses it in stream order, and the kernel runs on the same
    # (current) stream
    qrows = None if self_search else query_rows(query_mask)
    d2, idx = _knn_kernel(query.contiguous(), qrows, pack, k,
                          self_search=self_search)
    if max_radius is not None:
        d2, idx = _apply_radius(d2, idx, max_radius)
    return d2, idx


knn.launches = 0  # kernel launches (the plain path adds none)
knn.launches_by_shape = {}  # (D, k) -> launches


def nn1(query, ref, query_mask=None, ref_mask=None, max_radius=None,
        pack: Optional[KnnPack] = None):
    """1-NN convenience wrapper: returns ``(dists2 [N], idx [N])``."""
    d2, idx = knn(query, ref, query_mask, ref_mask, k=1,
                  max_radius=max_radius, pack=pack)
    return d2[:, 0], idx[:, 0]


def radius_knn(query, ref, query_mask=None, ref_mask=None, k: int = 1,
               max_radius=None, q_tile: int = 2048, W: int = 8192):
    """k-NN with an optional radius: without a radius, the brute-force
    search; with one, the sorted sweep (``nn_sweep.sweep_knn``; the port has
    no grid hash).  Returns ``(dists2, idx, overflow)``: the first two as
    :func:`knn` returns them, ``overflow`` the sweep's count of overflowing
    tiles as a 0-d tensor on the queries' device (0 without a radius, where
    nothing is capped), so that no cap is silent."""
    if max_radius is None:
        d2, idx = knn(query, ref, query_mask, ref_mask, k=k)
        return d2, idx, torch.zeros((), dtype=torch.int64,
                                    device=query.device)
    from .nn_sweep import sweep_knn
    return sweep_knn(query, ref, query_mask, ref_mask, k=k,
                     max_radius=max_radius, q_tile=q_tile, W=W)
