"""Counter-based uniforms for the solve's step filters (``csrc/philox.cu``).

The JAX package draws a matcher pass's step-filter uniforms inside its
``lax.while_loop`` from ``fold_in(key, it)`` (``icp/engine.py:585``,
``parallel/sharded_map.py:692``): the numbers are a function of the key and
the loop's device counter, so the loop needs no host.  The port's
counterpart is Philox4x32-10 (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC'11), a function of a key and a counter:

    key      (seed mod 2**32, seed // 2**32 mod 2**32)
    counter  (row // 4, it, solve, call)
    draw     word row % 4 of the block, as (word >> 8) * 2**-24 in [0, 1)

``solve`` (0-d int64, taken mod 2**32) numbers the solves of a
``DrawSource``, ``it`` (0-d int32) is the loop's iteration counter, ``row``
the reading's original row, ``call`` the draw's place among the draws of one
matcher pass (a step chain with two drawing filters).  ``solve`` and ``it``
are read on the device, so a CUDA graph replays new draws at every pass and
every solve.  The numbers are not the TPU's: the tests feed both packages
the same draws, or compare distributions.

The kernels
-----------
On a CUDA ``it`` :func:`philox_uniform` launches ``philox_uniform_kernel``
of ``csrc/philox.cu``: one thread per block of four rows, ten rounds of two
32x32->64 products in registers, four floats written.  A RandomSampling step
filter needs only its keep bit, ``mask & (u < prob)``: :func:`philox_keep`
launches ``philox_keep_kernel``, one thread per row of the solve, which
reads the row's original index from ``rows`` (the sweep's sort of the
reading), draws that row's word and writes the bit -- one launch per pass
instead of a draw, a fill, a compare, a mask ``&`` and the gathers that
permuted the reading back to its original order.  Both kernels share the
rounds (``csrc/philox.cuh``).  What bounds them on an H100: bytes (4 per row
written; 8 + 1 read and 1 written per row for the keep bit), and at the
solve's 49,152 rows the launch.  :func:`philox_plain` and
:func:`philox_keep_plain` compute the same bits in ordinary tensor
operations (torch has no uint32 product: int64 with 16-bit split products);
the CPU path and the tests use them, and a CUDA tensor never takes them from
the wrappers.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

__all__ = ["philox_uniform", "philox_plain", "philox_keep",
           "philox_keep_plain", "philox_key"]

M0, M1 = 0xD2511F53, 0xCD9E8D57  # the round's multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85  # the key schedule's increments
ROUNDS = 10
_M32 = 0xFFFFFFFF


def philox_key(seed: int):
    """The two key words of ``seed`` (any Python int)."""
    s = int(seed) & ((1 << 64) - 1)
    return s & _M32, s >> 32


def _mulhilo(a: torch.Tensor, m: int):
    """High and low 32-bit words of ``a * m`` (``a`` int64 in [0, 2**32),
    ``m`` a 32-bit constant) without leaving int64: ``m`` is split into two
    16-bit halves, each partial product stays below 2**48."""
    p0 = a * (m & 0xFFFF)
    p1 = a * (m >> 16)
    t = p0 + ((p1 & 0xFFFF) << 16)
    return ((p1 >> 16) + (t >> 32)) & _M32, t & _M32


def _check(solve: torch.Tensor, it: torch.Tensor, n: int):
    if solve.shape != () or solve.dtype != torch.int64:
        raise ValueError("philox: `solve` is a 0-d int64 tensor")
    if it.shape != () or it.dtype != torch.int32:
        raise ValueError("philox: `it` is a 0-d int32 tensor")
    if solve.device != it.device:
        raise ValueError("philox: `solve` and `it` on one device")
    if n < 0:
        raise ValueError("philox: n >= 0")


def philox_plain(seed: int, solve: torch.Tensor, it: torch.Tensor,
                 call: int, n: int) -> torch.Tensor:
    """:func:`philox_uniform` in ordinary tensor operations, on the device
    of ``it``."""
    _check(solve, it, n)
    dev = it.device
    blocks = (n + 3) // 4
    k0, k1 = philox_key(seed)
    c0 = torch.arange(blocks, dtype=torch.int64, device=dev)
    c1 = (it.to(torch.int64) & _M32).expand(blocks)
    c2 = (solve & _M32).expand(blocks)
    c3 = torch.full((blocks,), int(call) & _M32, dtype=torch.int64,
                    device=dev)
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & _M32, (k1 + W1) & _M32
        hi0, lo0 = _mulhilo(c0, M0)
        hi1, lo1 = _mulhilo(c2, M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    words = torch.stack([c0, c1, c2, c3], dim=1).reshape(-1)[:n]
    return (words >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _kernel(seed, solve, it, call, n):
    from ._build import load
    out = torch.empty((n,), dtype=torch.float32, device=it.device)
    if n > 0:
        fn = load("philox").philox_uniform_launch
        if not getattr(fn, "_typed", False):
            vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
            fn.argtypes = [cu, cu, vp, vp, cu, ci, vp, vp]
            fn.restype = ci
            fn._typed = True
        k0, k1 = philox_key(seed)
        with torch.cuda.device(it.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(k0, k1, solve.data_ptr(), it.data_ptr(),
                     int(call) & _M32, n, out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"philox kernel launch failed (code {err})")
        philox_uniform.launches += 1
        philox_uniform.launches_by_shape[(n,)] = \
            philox_uniform.launches_by_shape.get((n,), 0) + 1
    return out


def philox_uniform(seed: int, solve: torch.Tensor, it: torch.Tensor,
                   call: int, n: int) -> torch.Tensor:
    """``n`` float32 uniforms in ``[0, 1)`` keyed by ``seed`` and counted by
    (``solve``, ``it``, row, ``call``), on the device of ``it``.  ``solve``
    (0-d int64) and ``it`` (0-d int32) are read on that device, never on the
    host.  A CUDA ``it`` launches ``csrc/philox.cu`` (or raises); a CPU one
    runs :func:`philox_plain`."""
    _check(solve, it, n)
    if it.is_cuda:
        return _kernel(seed, solve, it, call, n)
    return philox_plain(seed, solve, it, call, n)


philox_uniform.launches = 0  # kernel launches (the plain path adds none)
philox_uniform.launches_by_shape = {}  # (n,) -> launches


def _check_keep(solve, it, mask, rows):
    n = mask.shape[0] if mask.ndim == 1 else -1
    _check(solve, it, max(n, 0))
    if mask.ndim != 1 or mask.dtype != torch.bool:
        raise ValueError("philox_keep: `mask` is a 1-d bool tensor")
    if mask.device != it.device:
        raise ValueError("philox_keep: `mask` on the device of `it`")
    if rows is not None and (rows.shape != mask.shape
                             or rows.dtype != torch.int64
                             or rows.device != it.device):
        raise ValueError("philox_keep: `rows` is an int64 tensor shaped and "
                         "placed like `mask`")


def philox_keep_plain(seed: int, solve: torch.Tensor, it: torch.Tensor,
                      call: int, prob: float, mask: torch.Tensor,
                      rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`philox_keep` in ordinary tensor operations: the uniforms of
    :func:`philox_plain`, gathered by ``rows``, compared with ``prob`` in
    float32 and masked."""
    _check_keep(solve, it, mask, rows)
    u = philox_plain(seed, solve, it, call, mask.shape[0])
    if rows is not None:
        u = u[rows]
    return mask & (u < torch.full((), prob, dtype=torch.float32,
                                  device=u.device))


def _keep_kernel(seed, solve, it, call, prob, mask, rows):
    from ._build import load
    n = mask.shape[0]
    keep = torch.empty((n,), dtype=torch.bool, device=mask.device)
    if n > 0:
        fn = load("philox").philox_keep_launch
        if not getattr(fn, "_typed", False):
            vp, ci, cu = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint
            fn.argtypes = [cu, cu, vp, vp, cu, ctypes.c_float, vp, vp, ci,
                           vp, vp]
            fn.restype = ci
            fn._typed = True
        k0, k1 = philox_key(seed)
        mask = mask.contiguous()
        rows = None if rows is None else rows.contiguous()
        with torch.cuda.device(it.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(k0, k1, solve.data_ptr(), it.data_ptr(),
                     int(call) & _M32, float(prob), mask.data_ptr(),
                     None if rows is None else rows.data_ptr(), n,
                     keep.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"philox_keep kernel launch failed "
                               f"(code {err})")
        philox_keep.launches += 1
        philox_keep.launches_by_shape[(n,)] = \
            philox_keep.launches_by_shape.get((n,), 0) + 1
    return keep


def philox_keep(seed: int, solve: torch.Tensor, it: torch.Tensor, call: int,
                prob: float, mask: torch.Tensor,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A RandomSampling filter's keep mask from its keyed draws:
    ``mask[j] & (u[rows[j]] < prob)``, ``u`` the uniforms of
    :func:`philox_uniform` for ``mask.shape[0]`` rows and ``rows`` (int64,
    a permutation of the rows; None: the identity) the original row of each
    row, so that a reading the solve sorted draws as it would unsorted.
    ``prob`` is compared in float32.  A CUDA ``it`` launches
    ``csrc/philox.cu`` (or raises); a CPU one runs
    :func:`philox_keep_plain`."""
    _check_keep(solve, it, mask, rows)
    if it.is_cuda:
        return _keep_kernel(seed, solve, it, call, prob, mask, rows)
    return philox_keep_plain(seed, solve, it, call, prob, mask, rows)


philox_keep.launches = 0  # kernel launches (the plain path adds none)
philox_keep.launches_by_shape = {}  # (n,) -> launches
