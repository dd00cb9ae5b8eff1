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

* What bounds it on an H100: operations.  A pair costs D subtractions, D
  products, D-1 sums and a compare in f32; every query and reference is read
  once, ``12 k`` bytes are written per query.
* What the design does about it: nothing clever yet.  One thread per query,
  blocks of 128 queries, the references staged through shared memory in
  tiles of 256, the k best kept sorted in registers (buckets of 1, 4, 8, 16,
  32).  It examines every pair; blocks without a valid query read nothing.
* Differences from the TPU kernel, all deliberate: the distance is
  subtract-first exact f32 (the TPU kernel ranks by ``|r|^2 - 2 q.r`` from a
  matrix product, whose rounding error grows as ``eps * |x|^2``); no planar
  ``[8, N]`` layout and no 1e9 sentinel coordinates (valid references are
  packed to the front by :func:`pack_refs`, and the kernel reads their count
  from device memory, so no count comes to the host); nothing is padded to
  1024; ties go to the lower index; ``k`` is at most ``MAX_K`` and a larger
  one raises.

On a CPU tensor ``knn`` runs :func:`knn_plain`, the same function in
ordinary tensor operations, which the tests and the on-card comparison use
on any device.  A CUDA tensor never takes it from ``knn``: the kernel
launches or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .nn_sweep import _check_kernel_args, _pair_d2

__all__ = ["knn", "nn1", "radius_knn", "knn_plain", "pack_refs", "KnnPack",
           "MAX_K"]

MAX_K = 32  # largest register list of the kernel
_PLAIN_Q_CHUNK = 16384  # queries per chunk of the plain version


class KnnPack(NamedTuple):
    """The references as the kernel reads them, built by :func:`pack_refs`
    once per change of the reference cloud."""
    ref_c: torch.Tensor  # f32[M, D] valid refs first, original order kept
    ids: torch.Tensor  # i32[M] packed position -> original index
    n_valid: torch.Tensor  # 0-d i64, on the refs' device


def pack_refs(ref: torch.Tensor, ref_mask: Optional[torch.Tensor]) -> KnnPack:
    """Valid references to the front (a stable sort of the mask, so the
    original order -- and with it the tie rule -- is kept), with their
    original indices and their count.  Nothing is read back to the host."""
    m = ref.shape[0]
    if ref_mask is None:
        ids = torch.arange(m, dtype=torch.int32, device=ref.device)
        return KnnPack(ref.contiguous(), ids,
                       torch.tensor(m, dtype=torch.int64, device=ref.device))
    order = torch.sort((~ref_mask).to(torch.uint8), stable=True).indices
    return KnnPack(ref[order].contiguous(), order.to(torch.int32),
                   ref_mask.sum())


def _knn_kernel(query, query_mask, pack: KnnPack, k: int):
    """Launch ``csrc/knn_brute.cu`` on the current stream."""
    from ._build import load
    n, dim = query.shape
    if dim not in (2, 3):
        raise ValueError(f"knn kernel supports D in (2, 3); got D={dim}")
    if query.dtype != torch.float32 or pack.ref_c.dtype != torch.float32:
        raise ValueError("knn kernel needs float32 coordinates")
    if pack.ref_c.ndim != 2 or pack.ref_c.shape[1] != dim:
        raise ValueError("knn kernel: queries and references differ in D")
    if pack.ids.dtype != torch.int32 or pack.n_valid.dtype != torch.int64:
        raise ValueError("knn kernel: the reference pack has int32 ids and "
                         "an int64 count")
    tensors = [query, pack.ref_c, pack.ids, pack.n_valid]
    qm8 = None
    if query_mask is not None:
        qm8 = query_mask.to(torch.uint8)
        tensors.append(qm8)
    _check_kernel_args(*tensors)
    d_out = torch.empty((n, k), dtype=torch.float32, device=query.device)
    i_out = torch.empty((n, k), dtype=torch.int64, device=query.device)
    if n == 0:
        return d_out, i_out  # no query, no launch
    ref_c = pack.ref_c
    if ref_c.shape[0] == 0:
        # never read (the count is 0), but the pointer must be valid
        ref_c = query.new_zeros((1, dim))
    lib = load("knn_brute")
    fn = lib.knn_brute_launch
    if not getattr(fn, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp, vp, vp]
        fn.restype = ci
        fn._typed = True
    with torch.cuda.device(query.device):
        stream = torch.cuda.current_stream().cuda_stream
        # qm8 is a temporary: the allocator reuses its memory in stream
        # order and the kernel runs on the same (current) stream
        err = fn(query.data_ptr(), None if qm8 is None else qm8.data_ptr(),
                 ref_c.data_ptr(), pack.ids.data_ptr(),
                 pack.n_valid.data_ptr(), n, dim, k, d_out.data_ptr(),
                 i_out.data_ptr(), stream)
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
    builds it once).  A CUDA ``query`` launches the hand-written kernel (or
    raises); a CPU ``query`` runs the plain version.
    """
    if not 1 <= k <= MAX_K:
        raise ValueError(f"knn supports 1 <= k <= {MAX_K}; got k={k}")
    if not query.is_cuda:
        return knn_plain(query, ref, query_mask, ref_mask, k, max_radius)
    if pack is None:
        pack = pack_refs(ref, ref_mask)
    d2, idx = _knn_kernel(query.contiguous(), query_mask, pack, k)
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
