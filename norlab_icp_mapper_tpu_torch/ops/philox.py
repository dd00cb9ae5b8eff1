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

The kernel
----------
On a CUDA ``it`` :func:`philox_uniform` launches ``csrc/philox.cu``: one
thread per block of four rows, ten rounds of two 32x32->64 products in
registers, four floats written.  What bounds it on an H100: bytes (4 per
row written; ~30 integer operations per row), and at the solve's 49,152
rows the launch.  :func:`philox_plain` computes the same bits in ordinary
tensor operations (torch has no uint32 product: int64 with 16-bit split
products); the CPU path and the tests use it, and a CUDA tensor never takes
it from the wrapper.
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["philox_uniform", "philox_plain", "philox_key"]

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
