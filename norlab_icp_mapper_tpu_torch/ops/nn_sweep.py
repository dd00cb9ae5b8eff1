"""Sorted-sweep windowed k-NN: radius-capped search at a fraction of the
brute-force pair count.

Idea: sort reference AND query points along one axis (x).  A tile of
``q_tile`` consecutive sorted queries has its candidates in the contiguous
reference range whose x lies within ``[tile_min - r, tile_max + r]`` -- found
with two ``searchsorted``.  Each tile searches at most ``W`` references from
the start of that range.  Pair work drops from N*M to about N*W.

Coordinates are centered on the reference centroid first (the centroid is
cached in the presort pack): squared distances are translation invariant,
and smaller magnitudes shrink their absolute rounding error.

Exactness: guaranteed when every live tile's candidate span fits in ``W``.
The third return value ``overflow`` counts live query tiles whose span
exceeded ``W`` -- those tiles degrade to nearest-within-window (still
radius-verified).  Callers must surface it: no cap is silent.

The kernel
----------
On a CUDA tensor ``sweep_knn`` launches ``csrc/sweep_knn.cu``, written by
hand for Hopper; it replaces the Pallas TPU kernel ``_fused_kernel``
(``ops/nn_sweep.py`` of the JAX package, launched by ``_sweep_fused``).

* What bounds it on an H100: operations, and among them instruction dispatch.
  A candidate pair costs 3 subtractions, 3 products and 2 sums in f32, each
  rounded on its own, plus its ranking; the references of a window are read
  once and then served from shared memory, the outputs are ``12 k`` bytes
  per query.  On top of that the windows differ in length: with one block
  per window the launch ended with its longest window.
* What the design does about it.  It examines fewer pairs: ``q_tile`` stays
  the unit of the ``W`` cap and of ``overflow``, but the kernel works in
  blocks of 256 consecutive queries (2 per thread), and the wrapper gives
  every block the part of its tile's window that its own queries can reach.
  Any window that holds every reference within ``r`` of a query gives that
  query the same answer, so the narrower windows change no result where
  ``overflow == 0``.  The pair loop is the one of the brute-force search
  (``csrc/sweep_common.cuh``): sorted references packed as ``f32[M, 4]``
  with the original index in the fourth lane (one 128-bit load a reference,
  no gather through the sort order afterwards), ``cp.async`` staging in a
  two-deep ring, ranking by groups.  A window is cut into chunks of equal
  length (:func:`chunking`); the blocks of one window form a thread-block
  cluster and merge their lists in distributed shared memory, so blocks
  differ by at most a chunk and a long window no longer sets the time.
* Tensor cores are not used: the product has a depth of 3, and the expanded
  form in TF32 (or split three ways) loses the digits that the radius gate,
  the tie rule and bit-identity with the plain version need; the JAX
  package's reduced-precision tiers were measured and refuted.
* Differences from the TPU kernel, all deliberate: no packed integer keys
  (k > 1 returns exact f32 distances under the rule ``d2 <= r^2``, as the
  reference's ``packed=False`` path does), no planar ``[8, N]`` layout, no
  1e9 sentinel coordinates inside the kernel (windows are clipped to the
  valid references instead), and none of the reduced-precision ranking
  tiers.

On a CPU tensor the wrapper runs ``_search_plain``, the same function in
ordinary tensor operations; ``sweep_knn_plain`` forces that path on any
device and is what the tests and the on-card comparison use.  A CUDA tensor
never takes it from ``sweep_knn``: the kernel launches or the call raises.
:func:`search_chunked_plain` walks the kernel's chunks and their merge in
ordinary tensor operations, for the tests and the on-card comparison.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

__all__ = ["sweep_knn", "sweep_knn_plain", "presort_ref", "presort_queries",
           "masked_centroid",
           "RefPack", "BIG", "sweep_windows", "pack_rows4", "chunking",
           "search_chunked_plain"]

BIG = 1.0e9  # x given to invalid points so that they sort to the end
_KERNEL_BLOCK = 128  # threads per kernel block
_BLOCK_QUERIES = 256  # queries per block of the sweep_knn kernel (2 a thread)
_MAX_K = 6
_MAX_CHUNK = 2048  # references per block of a window, at most
_MAX_CHUNKS = 8  # blocks per cluster


def pack_rows4(coords: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``f32[M, 4]`` as the pair loop reads it: the coordinates (z = 0 at
    D = 2) and, in the fourth lane, ``ids`` as the bits of an int32.  The
    fourth lane is only ever copied, never computed with."""
    m, dim = coords.shape
    if dim not in (2, 3):
        raise ValueError(f"the packed layout holds D in (2, 3); got D={dim}")
    out = torch.empty((m, 4), dtype=torch.float32, device=coords.device)
    out[:, :dim] = coords
    if dim == 2:
        out[:, 2] = 0.0
    out.view(torch.int32)[:, 3] = ids  # converted to int32 by the copy
    return out


def chunking(W: int) -> Tuple[int, int]:
    """``(chunks, chunk)``: a window of at most ``W`` references is cut into
    ``chunks`` (1, 2, 4 or 8: the blocks of a cluster) pieces of ``chunk``
    references (a multiple of 16), the fewest that keep a piece at or below
    ``_MAX_CHUNK``."""
    chunks = 1
    while chunks < _MAX_CHUNKS and -(-W // chunks) > _MAX_CHUNK:
        chunks *= 2
    chunk = max(16, -(-(-(-W // chunks)) // 16) * 16)
    return chunks, chunk


class RefPack(NamedTuple):
    """The sorted reference, built once per map change by ``presort_ref``."""
    ref_s: torch.Tensor  # f32[M, 4] centered refs in ascending-x order
    #                      (x, y, z or 0, bits of the original index)
    ref_mask_s: torch.Tensor  # bool[M] validity in that order
    ref_xs: torch.Tensor  # f32[M] sorted x, BIG for invalid refs
    ref_order: torch.Tensor  # i64[M] sorted position -> original index
    n_valid: torch.Tensor  # 0-d i64: invalid refs sort after the valid ones
    center: torch.Tensor  # f32[D] centroid of the valid refs


def masked_centroid(x: torch.Tensor, mask: torch.Tensor,
                    n_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``f32[D]``: the mean of the valid rows of ``x`` (zeros if none);
    ``n_valid`` is ``mask.sum()`` where the caller already has it."""
    if n_valid is None:
        n_valid = mask.sum()
    denom = torch.clamp(n_valid, min=1).to(torch.float32)
    return torch.where(mask[:, None], x, 0.0).sum(0) / denom


def presort_ref(ref: torch.Tensor, ref_mask: torch.Tensor,
                center: Optional[torch.Tensor] = None) -> RefPack:
    """Sort refs by x, invalid refs to the end (x -> BIG), CENTERED on the
    valid-ref centroid (or on ``center``, for a cloud that shares another
    cloud's frame).

    The reference cloud is static across the iterations of a solve (and
    across scans until a merge), so the sort is hoisted out of the loop.
    ``sweep_knn`` subtracts the same ``center`` from the queries."""
    n_valid = ref_mask.sum()
    if center is None:
        center = masked_centroid(ref, ref_mask, n_valid)
    ref_c = ref - center
    ref_xs, ref_order = torch.sort(torch.where(ref_mask, ref_c[:, 0], BIG),
                                   stable=True)
    return RefPack(pack_rows4(ref_c[ref_order], ref_order),
                   ref_mask[ref_order], ref_xs, ref_order, n_valid, center)


def presort_queries(pos: torch.Tensor, mask: torch.Tensor):
    """Query sort order by x (invalid to the end) + its inverse permutation.

    A solve searches once per iteration for the SAME reading moved by a
    slightly different rigid transform: the x ordering of the initial
    positions stays near-sorted (tile spans are re-measured from the moved
    coordinates each call, so a stale order only widens windows)."""
    q_x = torch.where(mask, pos[:, 0], torch.full_like(pos[:, 0], BIG))
    q_order = torch.sort(q_x, stable=True).indices
    n = pos.shape[0]
    inv = torch.empty_like(q_order)
    inv[q_order] = torch.arange(n, device=pos.device)
    return q_order, inv


def pad_rows(x: torch.Tensor, pad: int, value) -> torch.Tensor:
    """``x`` with ``pad`` rows of ``value`` appended."""
    if pad == 0:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), value)])


def _group_extent(x: torch.Tensor, m: torch.Tensor, group: int):
    """Min and max x of the valid members of each group of ``group``
    consecutive entries (BIG / -BIG for a group with none), and liveness."""
    xg = x.view(-1, group)
    mg = m.view(-1, group)
    big = torch.full_like(xg, BIG)
    gmin = torch.where(mg, xg, big).amin(1)
    gmax = torch.where(mg, xg, -big).amax(1)
    return gmin, gmax, mg.any(1)


def sweep_windows(qx_s: torch.Tensor, qm_s: torch.Tensor, pack: RefPack,
                  r: torch.Tensor, q_tile: int, W: int, block: int):
    """The window schedule shared by the kernel and the plain version.

    ``qx_s`` / ``qm_s`` are the sorted, padded query x and mask (length a
    multiple of ``q_tile``; ``block`` divides ``q_tile``).

    Returns ``(tile_start, tile_end, live, overflow, blk_start, blk_end)``:
    per ``q_tile`` tile the searched range ``[lo, min(hi, lo + W))`` of the
    sorted refs, clipped to the valid refs, whether the tile has a valid
    query, the number of live tiles with ``hi - lo > W``; and per block of
    ``block`` queries the part of its tile's range that the block's own
    queries can reach."""
    ref_xs = pack.ref_xs
    tile_min, tile_max, live = _group_extent(qx_s, qm_s, q_tile)
    # int32 positions: what the kernels read, so nothing is converted later
    lo = torch.searchsorted(ref_xs, tile_min - r, out_int32=True)
    hi = torch.searchsorted(ref_xs, tile_max + r, out_int32=True)
    overflow = (live & ((hi - lo) > W)).sum()
    t_end = torch.minimum(torch.minimum(hi, lo + W),
                          pack.n_valid.to(torch.int32))
    t_end = torch.where(live, t_end, lo)
    t_end = torch.maximum(t_end, lo)

    per = q_tile // block
    b_min, b_max, _ = _group_extent(qx_s, qm_s, block)
    b_lo = torch.searchsorted(ref_xs, b_min - r, out_int32=True)
    # right side: a superset of what the tile-level (left) bound admits
    b_hi = torch.searchsorted(ref_xs, b_max + r, right=True, out_int32=True)
    b_start = torch.maximum(b_lo, lo.repeat_interleave(per))
    b_end = torch.minimum(b_hi, t_end.repeat_interleave(per))
    b_end = torch.maximum(b_end, b_start)
    return lo, t_end, live, overflow, b_start, b_end


def _pair_d2(q: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Subtract-first squared distances [Q, Wt]; products and sums are
    separate f32 operations in coordinate order (what the kernel does)."""
    d = win[None, :, 0] - q[:, None, 0]
    s = d * d
    for a in range(1, q.shape[1]):
        d = win[None, :, a] - q[:, None, a]
        s = s + d * d
    return s


def _search_plain(q_s, qm_s, ref_s, t_start, t_end, live, r2, k, q_tile):
    """Plain version of the kernel: per live tile, distances to the tile's
    window, k rounds of (min, first argmin)."""
    n_pad = q_s.shape[0]
    dev = q_s.device
    d_out = torch.full((n_pad, k), float("inf"), dtype=torch.float32,
                       device=dev)
    i_out = torch.full((n_pad, k), -1, dtype=torch.int32, device=dev)
    starts, ends, lives = t_start.tolist(), t_end.tolist(), live.tolist()
    inf = float("inf")
    for t, (s0, e0, lv) in enumerate(zip(starts, ends, lives)):
        if not lv or e0 <= s0:
            continue
        sl = slice(t * q_tile, (t + 1) * q_tile)
        d2 = _pair_d2(q_s[sl], ref_s[s0:e0])
        d2 = torch.where((d2 <= r2) & qm_s[sl, None], d2,
                         torch.full_like(d2, inf))
        for j in range(min(k, e0 - s0)):
            m, a = d2.min(dim=1)  # first minimal index on ties
            found = torch.isfinite(m)
            d_out[sl, j] = m
            i_out[sl, j] = torch.where(found, a + s0,
                                       torch.full_like(a, -1)).to(torch.int32)
            if j + 1 < k:
                d2.scatter_(1, a[:, None], inf)
    return d_out, i_out


def merge_ranges_plain(parts: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                       k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernels' merge step in plain tensor operations: ``parts`` are the
    ``(d2 [N, k'], idx [N, k'])`` lists of contiguous ascending ranges of the
    references, each ascending with ties by lower index; returns the k best
    of their union under the same rule.  The lists are laid side by side in
    range order and k rounds of (min, first argmin) pick from them: the
    first minimal position is the lower range, and inside a range the
    earlier entry."""
    cat_d = torch.cat([d for d, _ in parts], dim=1).clone()
    cat_i = torch.cat([i for _, i in parts], dim=1)
    n = cat_d.shape[0]
    inf = float("inf")
    best_d = torch.full((n, k), inf, dtype=cat_d.dtype, device=cat_d.device)
    best_i = torch.full((n, k), -1, dtype=cat_i.dtype, device=cat_d.device)
    for j in range(min(k, cat_d.shape[1])):
        mval, a = cat_d.min(dim=1)
        best_d[:, j] = mval
        best_i[:, j] = torch.gather(cat_i, 1, a[:, None])[:, 0]
        cat_d.scatter_(1, a[:, None], inf)
    found = torch.isfinite(best_d)
    return best_d, torch.where(found, best_i, torch.full_like(best_i, -1))


def search_chunked_plain(q_s, qm_s, ref_s, b_start, b_end, r2, k, block,
                         chunks, chunk):
    """The kernel's schedule in plain tensor operations: every block of
    ``block`` sorted queries against each of the ``chunks`` pieces of
    ``chunk`` references of its window (a piece beyond the window's end is
    empty), the partial lists merged by :func:`merge_ranges_plain`.  Returns
    what :func:`_search_plain` returns on the same windows: distances and
    sorted positions.  For the tests and the on-card comparison only."""
    live = torch.ones_like(b_start, dtype=torch.bool)
    parts = []
    for c in range(chunks):
        c_start = torch.minimum(b_end, b_start + c * chunk)
        c_end = torch.minimum(b_end, c_start + chunk)
        parts.append(_search_plain(q_s, qm_s, ref_s, c_start, c_end, live,
                                   r2, k, block))
    return merge_ranges_plain(parts, k)


def _check_kernel_args(*tensors):
    for t in tensors:
        if not t.is_cuda:
            raise ValueError("kernel launch needs CUDA tensors")
        if not t.is_contiguous():
            raise ValueError("kernel launch needs contiguous tensors")


def _search_kernel(q_s, qm_s, ref_s, b_start, b_end, r2, k, n_rows, W):
    """Launch ``csrc/sweep_knn.cu`` on the current stream: ``b_start`` /
    ``b_end`` are the windows of the blocks of ``_BLOCK_QUERIES`` sorted
    queries, none longer than ``W``.  Returns distances and ORIGINAL
    reference indices (the fourth lane of ``ref_s``), int64."""
    from ._build import load
    dim = q_s.shape[1]
    if dim not in (2, 3) or not 1 <= k <= _MAX_K:
        raise ValueError(f"sweep_knn kernel supports D in (2, 3) and "
                         f"1 <= k <= {_MAX_K}; got D={dim}, k={k}")
    if q_s.dtype != torch.float32 or ref_s.dtype != torch.float32:
        raise ValueError("sweep_knn kernel needs float32 coordinates")
    if ref_s.ndim != 2 or ref_s.shape[1] != 4:
        raise ValueError("sweep_knn kernel: the sorted references are "
                         "f32[M, 4] (presort_ref)")
    if qm_s.dtype != torch.bool:
        raise ValueError("sweep_knn kernel needs a bool query mask")
    # a bool tensor is one byte of 0 or 1 per element: the kernel reads it
    # as it is; the windows come as int32 from sweep_windows (no copy then)
    start32 = b_start.to(torch.int32)
    end32 = b_end.to(torch.int32)
    _check_kernel_args(q_s, qm_s, ref_s, start32, end32)
    if start32.shape[0] * _BLOCK_QUERIES != n_rows:
        raise ValueError("sweep_knn kernel: one window per "
                         f"{_BLOCK_QUERIES} queries")
    if ref_s.shape[0] == 0:
        # the kernel never reads refs when every window is empty, but it
        # must be handed a valid pointer
        ref_s = q_s.new_zeros((1, 4))
    d_out = torch.empty((n_rows, k), dtype=torch.float32, device=q_s.device)
    i_out = torch.empty((n_rows, k), dtype=torch.int64, device=q_s.device)
    if n_rows == 0:
        return d_out, i_out  # no query, no launch
    chunks, chunk = chunking(max(int(W), 1))
    lib = load("sweep_knn")
    fn = lib.sweep_knn_launch
    if not getattr(fn, "_typed", False):
        if lib.sweep_knn_block_queries() != _BLOCK_QUERIES:
            raise RuntimeError("sweep_knn kernel and wrapper disagree on the "
                               "queries per block")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_float, ci, ci, ci, ci,
                       ci, ci, vp, vp, vp]
        fn.restype = ci
        fn._typed = True
    with torch.cuda.device(q_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q_s.data_ptr(), qm_s.data_ptr(), ref_s.data_ptr(),
                 start32.data_ptr(), end32.data_ptr(), r2, n_rows,
                 start32.shape[0], chunks, chunk, dim, k, d_out.data_ptr(),
                 i_out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"sweep_knn kernel launch failed (code {err})")
    sweep_knn.launches += 1
    key = (dim, k)
    sweep_knn.launches_by_shape[key] = \
        sweep_knn.launches_by_shape.get(key, 0) + 1
    return d_out, i_out


def _kernel_block_for(q_tile: int, block: int = _KERNEL_BLOCK) -> int:
    """``block`` (the queries a kernel block serves) if it divides
    ``q_tile``; raises otherwise."""
    if q_tile % block:
        raise ValueError(
            f"q_tile must be a multiple of {block} for the kernel; "
            f"got {q_tile}")
    return block


def _sweep(query, ref, query_mask, ref_mask, k, max_radius, q_tile, W,
           presorted, presorted_q, assume_sorted, force_plain):
    n, dim = query.shape
    m = ref.shape[0]
    dev = query.device
    if query_mask is None:
        query_mask = torch.ones((n,), dtype=torch.bool, device=dev)
    if ref_mask is None:
        ref_mask = torch.ones((m,), dtype=torch.bool, device=dev)
    W = min(W, m)
    # the radius is a host number: r^2 is rounded in f32 here, once, and the
    # kernel and the plain version compare against the same value
    r_host = np.float32(max_radius)
    r2 = float(r_host * r_host)
    # a fill, not a copy from the host: nothing here waits for the card
    r = torch.full((), float(r_host), dtype=torch.float32, device=dev)

    pack = presorted if presorted is not None else presort_ref(ref, ref_mask)

    # center + sort queries by x; invalid queries to the end
    query = query - pack.center
    q_x = torch.where(query_mask, query[:, 0],
                      torch.full_like(query[:, 0], BIG))
    n_pad = -(-n // q_tile) * q_tile
    pad = n_pad - n
    if assume_sorted:
        inv = None
        q_sorted, qm_sorted, qx_sorted = query, query_mask, q_x
    else:
        q_order, inv = (presorted_q if presorted_q is not None
                        else presort_queries(query, query_mask))
        q_sorted, qm_sorted, qx_sorted = \
            query[q_order], query_mask[q_order], q_x[q_order]
    q_s = pad_rows(q_sorted, pad, BIG)
    qm_s = pad_rows(qm_sorted, pad, False)
    qx_s = pad_rows(qx_sorted, pad, BIG)

    use_kernel = query.is_cuda and not force_plain
    block = (_kernel_block_for(q_tile, _BLOCK_QUERIES) if use_kernel
             else q_tile)
    t_start, t_end, live, overflow, b_start, b_end = sweep_windows(
        qx_s, qm_s, pack, r, q_tile, W, block)

    if use_kernel:
        # the kernel takes the original indices from the pack's fourth lane
        d_sorted, i_orig = _search_kernel(
            q_s.contiguous(), qm_s.contiguous(), pack.ref_s, b_start, b_end,
            r2, k, n_pad, W)
        d_sorted, i_orig = d_sorted[:n], i_orig[:n]
    else:
        d_sorted, i_sorted = _search_plain(
            q_s, qm_s, pack.ref_s, t_start, t_end, live, r2, k, q_tile)
        d_sorted = d_sorted[:n]
        i_sorted = i_sorted[:n].to(torch.int64)
        # sorted-ref positions -> original ref ids
        if m == 0:
            i_orig = torch.full_like(i_sorted, -1)
        else:
            i_orig = torch.where(i_sorted >= 0,
                                 pack.ref_order[torch.clamp(i_sorted, min=0)],
                                 torch.full_like(i_sorted, -1))
    if assume_sorted:
        return d_sorted, i_orig, overflow
    return d_sorted[inv], i_orig[inv], overflow


def sweep_knn(
    query: torch.Tensor,  # f32[N, D]
    ref: torch.Tensor,  # f32[M, D]
    query_mask: Optional[torch.Tensor] = None,
    ref_mask: Optional[torch.Tensor] = None,
    k: int = 1,
    max_radius: float = 2.0,
    q_tile: int = 4096,
    W: int = 8192,
    presorted: Optional[RefPack] = None,
    presorted_q=None,  # optional ``presort_queries`` output for ``query``
    assume_sorted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Radius-capped k-NN via the sorted sweep.

    Returns ``(dists2 f32[N, k], idx i64[N, k], overflow)``: exact squared
    distances ascending per query and indices into ``ref`` (``inf`` / ``-1``
    for no match within ``max_radius``, an invalid query or an invalid ref;
    ties resolve to the lowest sorted-ref position); ``overflow`` is the
    number of live ``q_tile`` tiles whose candidate span exceeded ``W``
    (0-d tensor, not read back here).

    ``presorted`` optionally supplies :func:`presort_ref`'s output (built
    from the same ``ref`` / ``ref_mask``).  ``assume_sorted=True``: ``query``
    is ALREADY in ascending-x order with invalid rows where the mask says --
    skips the per-call query gather and returns results in that same order.

    A CUDA ``query`` launches the hand-written kernel (or raises); a CPU
    ``query`` runs the plain version.
    """
    return _sweep(query, ref, query_mask, ref_mask, k, max_radius, q_tile, W,
                  presorted, presorted_q, assume_sorted, force_plain=False)


def sweep_knn_plain(query, ref, query_mask=None, ref_mask=None, k=1,
                    max_radius=2.0, q_tile=4096, W=8192, presorted=None,
                    presorted_q=None, assume_sorted=False):
    """:func:`sweep_knn` through the plain PyTorch version of the kernel, on
    whatever device the tensors lie (the yardstick of the comparison on the
    card; no speed is claimed for it)."""
    return _sweep(query, ref, query_mask, ref_mask, k, max_radius, q_tile, W,
                  presorted, presorted_q, assume_sorted, force_plain=True)


sweep_knn.launches = 0  # kernel launches (the plain path adds none)
sweep_knn.launches_by_shape = {}  # (D, k) -> launches
