"""Radius-neighborhood PCA: the surface-normal engine.

A surface normal only needs the *covariance of the neighborhood*, not the
identity of the k nearest points.  So instead of a top-k search this op
accumulates, per query point ``q_i``, the zeroth/first/second moments of all
reference points within ``max_radius``, taken about the query itself:

    cnt_i   = sum_j  w_ij
    sd_i    = sum_j  w_ij * d_ij               d_ij = x_j - q_i
    sdd_i   = sum_j  w_ij * d_ij d_ij^T        w_ij = [ |d_ij|^2 <= r^2 ]

    mean_i  = q_i + sd_i / cnt_i
    cov_i   = sdd_i / cnt_i - (sd_i / cnt_i)(sd_i / cnt_i)^T

on the same sorted-sweep schedule as ``nn_sweep.sweep_knn``.

Numerical note: the raw-moment form ``sum(x x^T)/cnt - mean mean^T`` cancels
catastrophically (error ~ eps * |x|^2 * cnt), which at a cloud extent of tens
of metres is above the smallest eigenvalue of a wall seen with 1 cm of noise.
Sums of ``d`` do not: ``|d| <= r``.  Both clouds are still centred on the
query cloud's masked mean first, exactly as the reference centres them, so
that the gate squares the same ``(x_j - c) - (q_i - c)``; ``mean`` is
returned in the original frame.

Semantics vs lpm: lpm fits the PCA to the k nearest neighbors (radius-capped
when maxDist is set); this op fits it to *all* neighbors within the radius.

The kernel
----------
On a CUDA tensor ``radius_pca`` and ``radius_pca_normals`` launch
``csrc/radius_pca.cu``, written by hand for Hopper; it replaces the Pallas TPU
kernel ``_pca_fused_kernel`` (``ops/pca.py:136`` of the JAX package, launched
by ``_pca_fused``) and, on this card, the tensor operations that XLA fused
around it under ``jit``.

* What bounds it on an H100: operations, and among them instruction
  dispatch -- the sweep matcher's per-pair distance test (8 unfused
  arithmetic steps and a compare) plus 13 for each pair that passes.  The
  window of a block is read once and served from shared memory; the outputs
  are ``4 (1 + 3 D + D D)`` bytes per query.  But the kernel alone was a
  twelfth of the phase it served: eager PyTorch spent the rest in some 180
  small launches around it (centring, gathers, windows, un-sort, covariance,
  a closed-form eigensolve of ~60 tensor operations).
* What the design does about it: one launch from sorted points to normals.
  The clouds are packed once as ``f32[M, 4]`` (centred coordinates and the
  original row, valid first, ascending x: ``nn_sweep.presort_ref``; a cloud
  against itself is its own query pack); threads exist for valid queries
  only, through the packed pair loop of ``csrc/sweep_common.cuh``, four
  lanes to a query, each taking every fourth reference of a staged tile (a
  map's valid queries alone are too few warps to hide the loop's
  latencies); a block finds its window by binary search over the packed x
  and counts its tile's overflow; the sums are per-query centred; mean,
  covariance, eigenvalues and normal (``csrc/sym_eig.cuh``) are computed in
  registers and written to the query's original row.  The TPU form's 0/1
  gate matrix, its ``M @ W`` matmul and the padding of the moment rows to 16
  are not carried over.

On a CPU tensor the wrappers run :func:`_stats_plain`, the same function in
ordinary tensor operations (windows from ``nn_sweep.sweep_windows``, the
closed forms of ``ops/eigen.py``); ``radius_pca_plain`` and
``radius_pca_normals_plain`` force it on any device for the tests and the
on-card comparison.  A CUDA tensor never takes it from the wrappers: the
kernel launches or the call raises.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import numpy as np
import torch

from .eigen import sym_eig2_plain, sym_eig3_plain
from .nn_sweep import (BIG, RefPack, _KERNEL_BLOCK, _check_kernel_args,
                       _pair_d2, pad_rows, presort_ref, sweep_windows)

__all__ = ["radius_pca", "radius_pca_plain", "radius_pca_normals",
           "radius_pca_normals_plain"]

_LANES_PER_QUERY = 4
_BLOCK_QUERIES = _KERNEL_BLOCK // _LANES_PER_QUERY  # queries per block


class PcaStats(NamedTuple):
    """Everything one pass computes, rows in the queries' original order."""
    cnt: torch.Tensor  # f32[N] neighbours within the radius
    mean: torch.Tensor  # f32[N, D] their mean, original frame
    cov: torch.Tensor  # f32[N, D, D] their covariance
    evals: torch.Tensor  # f32[N, D] its eigenvalues, ascending
    normals: torch.Tensor  # f32[N, D] unit eigenvector of the smallest
    overflow: torch.Tensor  # 0-d: live tiles whose candidates exceeded W


def _moments_epilogue(cnt, sd, sdd, q, center):
    """``(mean [N, D], cov [N, D, D])`` from the per-query centred sums, as
    the kernel's epilogue computes them: ``sd [N, D]`` the sum of
    ``d = x - q``, ``sdd [N, D (D + 1) / 2]`` the sum of ``d d^T`` (diagonal
    first, then xy, xz, yz), ``q`` the centred query.  ``mean`` is
    ``(q + sd / cnt) + center`` and zero where ``cnt == 0``."""
    dim = sd.shape[1]
    safe = torch.clamp(cnt, min=1.0)
    s = sd / safe[:, None]
    mean = torch.where(cnt[:, None] > 0, (q + s) + center,
                       torch.zeros_like(s))
    pairs = [(a, a) for a in range(dim)] + \
        [(a, b) for a in range(dim) for b in range(a + 1, dim)]
    upper = {ab: sdd[:, i] / safe - s[:, ab[0]] * s[:, ab[1]]
             for i, ab in enumerate(pairs)}
    cov = torch.stack([torch.stack([upper[(min(a, b), max(a, b))]
                                    for b in range(dim)], dim=1)
                       for a in range(dim)], dim=1)
    return mean, cov


def _normals_epilogue(cnt, cov, min_count: int):
    """Eigenvalues and normal of each covariance by the closed forms of
    ``ops/eigen.py``; neighbourhoods of fewer than ``min_count`` points get a
    unit normal along the last axis."""
    dim = cov.shape[-1]
    evals, normals = (sym_eig3_plain if dim == 3 else sym_eig2_plain)(cov)
    fallback = torch.zeros_like(normals)
    fallback[:, dim - 1] = 1.0
    few = cnt < float(min_count)
    return evals, torch.where(few[:, None], fallback, normals)


def _stats_plain(qp: RefPack, rp: RefPack, r: float, r2: float, q_tile: int,
                 W: int, min_count: int) -> PcaStats:
    """Plain version of the kernel: per live tile of ``q_tile`` sorted
    queries, ``d = window - query``, the gate from ``_pair_d2``, masked sums
    of ``d`` and ``d d^T``; then the kernel's epilogue in tensor operations
    and the rows scattered to the queries' original index."""
    n = qp.ref_s.shape[0]
    dim = qp.center.shape[0]
    dev = qp.ref_s.device
    pad = -(-n // q_tile) * q_tile - n
    q_s = pad_rows(qp.ref_s[:, :dim], pad, BIG)
    qm_s = pad_rows(qp.ref_mask_s, pad, False)
    qx_s = pad_rows(qp.ref_xs, pad, BIG)
    t_start, t_end, live, overflow, _, _ = sweep_windows(
        qx_s, qm_s, rp, torch.tensor(r, dtype=torch.float32, device=dev),
        q_tile, W, q_tile)
    ref_c = rp.ref_s[:, :dim]
    n_pad = q_s.shape[0]
    cnt = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    sd = torch.zeros((n_pad, dim), dtype=torch.float32, device=dev)
    sdd = torch.zeros((n_pad, dim * (dim + 1) // 2), dtype=torch.float32,
                      device=dev)
    starts, ends, lives = t_start.tolist(), t_end.tolist(), live.tolist()
    for t, (s0, e0, lv) in enumerate(zip(starts, ends, lives)):
        if not lv or e0 <= s0:
            continue
        sl = slice(t * q_tile, (t + 1) * q_tile)
        q, win = q_s[sl], ref_c[s0:e0]
        w = ((_pair_d2(q, win) <= r2) & qm_s[sl, None]).to(torch.float32)
        d = [win[None, :, a] - q[:, None, a] for a in range(dim)]  # [Q, Wt]
        cnt[sl] = w.sum(1)
        col = dim
        for a in range(dim):
            sd[sl, a] = (d[a] * w).sum(1)
            sdd[sl, a] = (d[a] * d[a] * w).sum(1)
        for a in range(dim):
            for b in range(a + 1, dim):
                sdd[sl, col] = (d[a] * d[b] * w).sum(1)
                col += 1
    mean, cov = _moments_epilogue(cnt, sd, sdd, q_s, qp.center)
    evals, normals = _normals_epilogue(cnt, cov, min_count)
    # valid queries come first in the sorted order; their original rows
    n_q = int(qp.n_valid)
    rows = qp.ref_order[:n_q]
    out = [torch.zeros((n,) + tuple(x.shape[1:]), dtype=torch.float32,
                       device=dev) for x in (cnt, mean, cov, evals, normals)]
    for o, x in zip(out, (cnt, mean, cov, evals, normals)):
        o[rows] = x[:n_q]
    return PcaStats(*out, overflow)


def _stats_kernel(qp: RefPack, rp: RefPack, r: float, r2: float, q_tile: int,
                  W: int, min_count: int) -> PcaStats:
    """Launch ``csrc/radius_pca.cu`` on the current stream: one launch from
    the two packs to every output."""
    from ._build import load
    n = qp.ref_s.shape[0]
    dim = qp.center.shape[0]
    dev = qp.ref_s.device
    if dim not in (2, 3):
        raise ValueError(f"radius_pca kernel supports D in (2, 3); got {dim}")
    for pack in (qp, rp):
        if (pack.ref_s.dtype != torch.float32 or pack.ref_s.ndim != 2
                or pack.ref_s.shape[1] != 4
                or pack.n_valid.dtype != torch.int64):
            raise ValueError("radius_pca kernel: a cloud is packed as "
                             "f32[M, 4] with an int64 count (presort_ref)")
    if q_tile % _BLOCK_QUERIES:
        raise ValueError(f"q_tile must be a multiple of {_BLOCK_QUERIES} "
                         f"for the kernel; got {q_tile}")
    if qp.center.dtype != torch.float32:
        raise ValueError("radius_pca kernel needs float32 coordinates")
    _check_kernel_args(qp.ref_s, qp.n_valid, rp.ref_s, rp.n_valid, qp.center)
    # one zero fill serves every output: rows without a valid query stay
    # zero, and the last word is the overflow counter
    widths = (1, dim, dim * dim, dim, dim)
    buf = torch.zeros((n * sum(widths) + 1,), dtype=torch.float32, device=dev)
    outs, at = [], 0
    for w in widths:
        outs.append(buf[at:at + n * w])
        at += n * w
    cnt = outs[0]
    mean, evals, normals = (outs[i].view(n, dim) for i in (1, 3, 4))
    cov = outs[2].view(n, dim, dim)
    overflow = buf[at:].view(torch.int32)[0]
    stats = PcaStats(cnt, mean, cov, evals, normals, overflow)
    if n == 0:
        return stats  # no query, no launch
    ref4 = rp.ref_s
    if ref4.shape[0] == 0:
        # never read (the count is 0), but the pointer must be valid
        ref4 = qp.ref_s.new_zeros((1, 4))
    lib = load("radius_pca")
    fn = lib.radius_pca_launch
    if not getattr(fn, "_typed", False):
        if lib.radius_pca_block_queries() != _BLOCK_QUERIES:
            raise RuntimeError("radius_pca kernel and wrapper disagree on "
                               "the queries per block")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp, ci, vp, vp, vp, vp, cf, cf, ci, ci, ci, ci, ci,
                       vp, vp, vp, vp, vp, vp, vp]
        fn.restype = ci
        fn._typed = True
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(qp.ref_s.data_ptr(), n, qp.n_valid.data_ptr(),
                 ref4.data_ptr(), rp.n_valid.data_ptr(), qp.center.data_ptr(),
                 r, r2, q_tile, W, min_count, n, dim, cnt.data_ptr(),
                 mean.data_ptr(), cov.data_ptr(), evals.data_ptr(),
                 normals.data_ptr(), overflow.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"radius_pca kernel launch failed (code {err})")
    radius_pca.launches += 1
    return stats


def _radius_pca(query, ref, query_mask, ref_mask, max_radius, q_tile, W,
                min_count, force_plain) -> PcaStats:
    n = query.shape[0]
    self_nn = query is ref and (query_mask is ref_mask)
    if query_mask is None:
        query_mask = torch.ones((n,), dtype=torch.bool, device=query.device)
        if self_nn:
            ref_mask = query_mask
    if ref_mask is None:
        ref_mask = torch.ones((ref.shape[0],), dtype=torch.bool,
                              device=ref.device)
    W = min(W, ref.shape[0])
    max_radius = float(max_radius)
    r = float(np.float32(max_radius))
    # the reference squares the radius in double and compares in f32
    r2 = float(np.float32(max_radius * max_radius))

    # both clouds centred on the query cloud's masked mean, sorted by x and
    # packed; a cloud against itself is packed once (its centroid comes with
    # the pack)
    if self_nn:
        qp = rp = presort_ref(query, query_mask)
    else:
        qp = presort_ref(query, query_mask)
        rp = presort_ref(ref, ref_mask, center=qp.center)
    run = _stats_plain if force_plain or not query.is_cuda else _stats_kernel
    return run(qp, rp, r, r2, q_tile, W, min_count)


def radius_pca(query, ref, query_mask: Optional[torch.Tensor] = None,
               ref_mask: Optional[torch.Tensor] = None, max_radius=1.0,
               q_tile: int = 2048, W: int = 4096):
    """Radius-neighborhood PCA statistics.

    Returns ``(cnt f32[N], mean f32[N, D], cov f32[N, D, D], overflow)``.
    Both clouds are centered on the query cloud's masked mean internally and
    the moments are taken about each query (see the module docstring on
    cancellation); ``mean`` is returned in the *original* frame.  Queries
    with no neighbor in range (or masked out) get cnt=0, mean=0, cov=0.
    Passing the same tensors as ``query`` and ``ref`` (and the same mask)
    selects the self-neighborhood form, which sorts and packs once.
    ``overflow`` counts the tiles of ``q_tile`` sorted queries whose
    candidate span exceeded ``W`` (their statistics come from the first
    ``W`` candidates; callers should surface it).

    A CUDA ``query`` launches the hand-written kernel (or raises); a CPU
    ``query`` runs the plain version.
    """
    s = _radius_pca(query, ref, query_mask, ref_mask, max_radius, q_tile, W,
                    0, force_plain=False)
    return s.cnt, s.mean, s.cov, s.overflow


def radius_pca_plain(query, ref, query_mask=None, ref_mask=None,
                     max_radius=1.0, q_tile: int = 2048, W: int = 4096):
    """:func:`radius_pca` through the plain PyTorch version of the kernel,
    on whatever device the tensors lie."""
    s = _radius_pca(query, ref, query_mask, ref_mask, max_radius, q_tile, W,
                    0, force_plain=True)
    return s.cnt, s.mean, s.cov, s.overflow


def radius_pca_normals(query, ref, query_mask=None, ref_mask=None,
                       max_radius=1.0, q_tile: int = 2048, W: int = 4096,
                       min_count: int = 0):
    """The same pass as :func:`radius_pca`, returning what a surface-normal
    filter needs: ``(cnt f32[N], evals f32[N, D] ascending, normals
    f32[N, D], overflow)``.  ``normals`` is the unit eigenvector of the
    smallest eigenvalue of the neighbourhood's covariance (closed forms of
    ``ops/eigen.py``); a neighbourhood of fewer than ``min_count`` points gets
    a unit normal along the last axis.  Rows of masked-out queries are zero.

    A CUDA ``query`` launches the hand-written kernel, once (or raises); a
    CPU ``query`` runs the plain version.
    """
    s = _radius_pca(query, ref, query_mask, ref_mask, max_radius, q_tile, W,
                    min_count, force_plain=False)
    return s.cnt, s.evals, s.normals, s.overflow


def radius_pca_normals_plain(query, ref, query_mask=None, ref_mask=None,
                             max_radius=1.0, q_tile: int = 2048,
                             W: int = 4096, min_count: int = 0):
    """:func:`radius_pca_normals` through the plain PyTorch version of the
    kernel, on whatever device the tensors lie."""
    s = _radius_pca(query, ref, query_mask, ref_mask, max_radius, q_tile, W,
                    min_count, force_plain=True)
    return s.cnt, s.evals, s.normals, s.overflow


# kernel launches of both wrappers (the plain path adds none)
radius_pca.launches = 0
