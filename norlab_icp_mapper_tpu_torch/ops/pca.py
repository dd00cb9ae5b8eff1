"""Radius-neighborhood PCA statistics: the surface-normal engine.

A surface normal only needs the *covariance of the neighborhood*, not the
identity of the k nearest points.  So instead of a top-k search this op
accumulates, per query point, the zeroth/first/second moments of all
reference points within ``max_radius``:

    cnt_i   = sum_j  w_ij
    sx_i    = sum_j  w_ij * x_j
    sxx_i   = sum_j  w_ij * x_j x_j^T          w_ij = [ |x_j - q_i|^2 <= r^2 ]

on the same sorted-sweep schedule as ``nn_sweep.sweep_knn``.

Numerical note: ``cov = sxx/cnt - mean mean^T`` cancels catastrophically
when coordinates are far from the origin (error ~ eps * |x|^2).
``radius_pca`` therefore centers both clouds on the query cloud's masked
mean first and restores ``mean + c`` afterwards.

Semantics vs lpm: lpm fits the PCA to the k nearest neighbors (radius-capped
when maxDist is set); this op fits it to *all* neighbors within the radius.

The kernel
----------
On a CUDA tensor ``radius_pca`` launches ``csrc/radius_pca.cu``, written by
hand for Hopper; it replaces the Pallas TPU kernel ``_pca_fused_kernel``
(``ops/pca.py`` of the JAX package, launched by ``_pca_fused``).

* What bounds it on an H100: operations -- the same per-pair distance test
  as the sweep matcher, plus ``n_moments`` adds for each pair that passes.
  Output is ``n_moments`` floats per query; the window of a block is read
  once and served from shared memory.
* What the design does about it: one thread per query holds its 10 (D=3) or
  6 (D=2) sums in registers, and blocks of 128 queries get windows narrowed
  to their own x range, as in ``nn_sweep``.  The TPU form's 0/1 gate matrix,
  its ``M @ W`` matmul and the padding of the moment rows to 16 are not
  carried over.

On a CPU tensor the wrapper runs ``_moments_plain``; ``radius_pca_plain``
forces it on any device for the tests and the on-card comparison.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .nn_sweep import (BIG, RefPack, _KERNEL_BLOCK, _check_kernel_args,
                       _kernel_block_for, _pair_d2, pad_rows, sweep_windows)

__all__ = ["radius_pca", "radius_pca_plain"]


def _n_moments(dim: int) -> int:
    # 1 (count) + D (sum) + D*(D+1)/2 (upper-triangular second moments)
    return 1 + dim + dim * (dim + 1) // 2


def _moment_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Stack moment rows for points given planar coords x [>=D, T]."""
    rows = [torch.ones_like(x[0])]
    rows += [x[a] for a in range(dim)]
    rows += [x[a] * x[a] for a in range(dim)]
    for a in range(dim):
        for b in range(a + 1, dim):
            rows.append(x[a] * x[b])
    return torch.stack(rows, dim=0)  # [n_moments, T]


def _unpack_stats(acc: torch.Tensor, dim: int):
    """acc [n_moments, N] -> (cnt [N], mean [N, D], cov [N, D, D])."""
    cnt = acc[0]
    safe = torch.clamp(cnt, min=1.0)
    mean = (acc[1:1 + dim] / safe).T  # [N, D]
    m2 = acc[1 + dim:1 + 2 * dim] / safe  # diag, [D, N]
    cov = torch.zeros((acc.shape[1], dim, dim), dtype=torch.float32,
                      device=acc.device)
    for a in range(dim):
        cov[:, a, a] = m2[a] - mean[:, a] * mean[:, a]
    r = 1 + 2 * dim
    for a in range(dim):
        for b in range(a + 1, dim):
            off = acc[r] / safe - mean[:, a] * mean[:, b]
            cov[:, a, b] = off
            cov[:, b, a] = off
            r += 1
    return cnt, mean, cov


def _moments_plain(q_s, qm_s, ref_s, t_start, t_end, live, r2, q_tile):
    """Plain version of the kernel: per live tile, the 0/1 gate of the
    tile's window times the window's moment rows."""
    n_pad, dim = q_s.shape
    nm = _n_moments(dim)
    acc = torch.zeros((nm, n_pad), dtype=torch.float32, device=q_s.device)
    starts, ends, lives = t_start.tolist(), t_end.tolist(), live.tolist()
    for t, (s0, e0, lv) in enumerate(zip(starts, ends, lives)):
        if not lv or e0 <= s0:
            continue
        sl = slice(t * q_tile, (t + 1) * q_tile)
        win = ref_s[s0:e0]
        w = ((_pair_d2(q_s[sl], win) <= r2)
             & qm_s[sl, None]).to(torch.float32)  # [Q, Wt]
        M = _moment_rows(win.T, dim)  # [nm, Wt]
        acc[:, sl] = M @ w.T
    return acc


def _moments_kernel(q_s, qm_s, ref_s, b_start, b_end, r2, n_rows):
    """Launch ``csrc/radius_pca.cu`` on the current stream."""
    from ._build import load
    dim = q_s.shape[1]
    if dim not in (2, 3):
        raise ValueError(f"radius_pca kernel supports D in (2, 3); got {dim}")
    if q_s.dtype != torch.float32 or ref_s.dtype != torch.float32:
        raise ValueError("radius_pca kernel needs float32 coordinates")
    qm8 = qm_s.to(torch.uint8)
    start32 = b_start.to(torch.int32)
    end32 = b_end.to(torch.int32)
    _check_kernel_args(q_s, qm8, ref_s, start32, end32)
    if ref_s.shape[0] == 0:
        ref_s = q_s.new_zeros((1, dim))
    out = torch.empty((_n_moments(dim), n_rows), dtype=torch.float32,
                      device=q_s.device)
    if n_rows == 0:
        return out  # no query, no launch
    lib = load("radius_pca")
    fn = lib.radius_pca_launch
    if not getattr(fn, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, ctypes.c_float, ci, ci, ci, ci,
                       vp, vp]
        fn.restype = ci
        fn._typed = True
    with torch.cuda.device(q_s.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q_s.data_ptr(), qm8.data_ptr(), ref_s.data_ptr(),
                 start32.data_ptr(), end32.data_ptr(), r2, n_rows,
                 start32.shape[0], _KERNEL_BLOCK, dim, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"radius_pca kernel launch failed (code {err})")
    radius_pca.launches += 1
    return out


def _radius_pca_sweep(query, ref, query_mask, ref_mask, max_radius,
                      q_tile: int = 2048, W: int = 4096,
                      self_neighborhood: bool = False,
                      force_plain: bool = False):
    """Sorted-sweep radius PCA: sort both clouds by x, each query tile only
    sees the contiguous ref window within ``[tile_min - r, tile_max + r]``
    (same schedule as ``nn_sweep.sweep_knn``).  Returns
    ``(cnt, mean, cov, overflow_tiles)`` -- ``overflow_tiles`` counts query
    tiles whose true candidate span exceeded ``W`` (their stats degrade to
    window-truncated; callers should surface it)."""
    n, dim = query.shape
    m = ref.shape[0]
    dev = query.device
    W = min(W, m)
    max_radius = float(max_radius)
    r = torch.tensor(max_radius, dtype=torch.float32, device=dev)
    # the reference squares the radius in double and compares in f32
    r2 = float(np.float32(max_radius * max_radius))

    ref_x = torch.where(ref_mask, ref[:, 0], torch.full_like(ref[:, 0], BIG))
    ref_order = torch.sort(ref_x, stable=True).indices
    ref_s = ref[ref_order].contiguous()
    ref_mask_s = ref_mask[ref_order]
    ref_xs = ref_x[ref_order].contiguous()
    pack = RefPack(ref_s, ref_mask_s, ref_xs, ref_order, ref_mask.sum(),
                   torch.zeros((dim,), dtype=torch.float32, device=dev))

    if self_neighborhood:
        # query IS ref (surface normals over one cloud): one sort and one
        # gather serve both sides
        q_order = ref_order
        q_sorted, qm_sorted, qx_sorted = ref_s, ref_mask_s, ref_xs
    else:
        q_x = torch.where(query_mask, query[:, 0],
                          torch.full_like(query[:, 0], BIG))
        q_order = torch.sort(q_x, stable=True).indices
        q_sorted, qm_sorted, qx_sorted = \
            query[q_order], query_mask[q_order], q_x[q_order]
    n_pad = -(-n // q_tile) * q_tile
    pad = n_pad - n
    q_s = pad_rows(q_sorted, pad, BIG)
    qm_s = pad_rows(qm_sorted, pad, False)
    qx_s = pad_rows(qx_sorted, pad, BIG)

    use_kernel = query.is_cuda and not force_plain
    block = _kernel_block_for(q_tile) if use_kernel else q_tile
    t_start, t_end, live, overflow, b_start, b_end = sweep_windows(
        qx_s, qm_s, pack, r, q_tile, W, block)

    if use_kernel:
        acc_sorted = _moments_kernel(q_s.contiguous(), qm_s.contiguous(),
                                     ref_s, b_start, b_end, r2, n_pad)
    else:
        acc_sorted = _moments_plain(q_s, qm_s, ref_s, t_start, t_end, live,
                                    r2, q_tile)
    acc_sorted = acc_sorted[:, :n]
    # un-sort queries
    inv = torch.empty_like(q_order)
    inv[q_order] = torch.arange(n, device=dev)
    acc = acc_sorted[:, inv]
    acc = torch.where(query_mask[None, :], acc, torch.zeros_like(acc))
    cnt, mean, cov = _unpack_stats(acc, dim)
    return cnt, mean, cov, overflow


def _radius_pca(query, ref, query_mask, ref_mask, max_radius, q_tile, W,
                force_plain):
    n, dim = query.shape
    self_nn = query is ref and (query_mask is ref_mask)
    if query_mask is None:
        query_mask = torch.ones((n,), dtype=torch.bool, device=query.device)
        if self_nn:
            ref_mask = query_mask
    if ref_mask is None:
        ref_mask = torch.ones((ref.shape[0],), dtype=torch.bool,
                              device=ref.device)

    # center on the query cloud's masked mean (cancellation mitigation)
    qsum = torch.where(query_mask[:, None], query,
                       torch.zeros_like(query)).sum(0)
    qcnt = torch.clamp(query_mask.to(torch.float32).sum(), min=1.0)
    c = qsum / qcnt
    qc = query - c
    rc = qc if self_nn else ref - c

    cnt, mean, cov, overflow = _radius_pca_sweep(
        qc, rc, query_mask, ref_mask, max_radius, q_tile=q_tile, W=W,
        self_neighborhood=self_nn, force_plain=force_plain)
    mean = mean + torch.where(cnt[:, None] > 0, c[None, :],
                              torch.zeros_like(c)[None, :])
    return cnt, mean, cov, overflow


def radius_pca(query, ref, query_mask: Optional[torch.Tensor] = None,
               ref_mask: Optional[torch.Tensor] = None, max_radius=1.0,
               q_tile: int = 2048, W: int = 4096):
    """Radius-neighborhood PCA statistics.

    Returns ``(cnt f32[N], mean f32[N, D], cov f32[N, D, D], overflow)``.
    Both clouds are centered on the query cloud's masked mean internally
    (see the module docstring on cancellation); ``mean`` is returned in the
    *original* frame.  Queries with no neighbor in range (or masked out) get
    cnt=0, mean=0, cov=0.  Passing the same tensors as ``query`` and ``ref``
    (and the same mask) selects the self-neighborhood form, which sorts once.

    A CUDA ``query`` launches the hand-written kernel (or raises); a CPU
    ``query`` runs the plain version.
    """
    return _radius_pca(query, ref, query_mask, ref_mask, max_radius, q_tile,
                       W, force_plain=False)


def radius_pca_plain(query, ref, query_mask=None, ref_mask=None,
                     max_radius=1.0, q_tile: int = 2048, W: int = 4096):
    """:func:`radius_pca` through the plain PyTorch version of the kernel,
    on whatever device the tensors lie."""
    return _radius_pca(query, ref, query_mask, ref_mask, max_radius, q_tile,
                       W, force_plain=True)


radius_pca.launches = 0  # kernel launches (the plain path adds none)
