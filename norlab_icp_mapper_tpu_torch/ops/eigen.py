"""Closed-form symmetric eigensolvers for tiny batched matrices.

The surface-normal pass needs one 3x3 (or 2x2) symmetric eigensolve per map
point.  ``torch.linalg.eigh`` on [N, 3, 3] goes through an iterative batched
solver; these are the analytic alternatives.

3x3: trigonometric (Cardano) eigenvalues + eigenvector from the product
``(A - l1 I)(A - l2 I)`` whose columns span the l0 eigenspace.
2x2: direct angle form.

The kernel
----------
The closed forms are some 60 elementwise tensor operations.  The JAX package
leaves them to XLA, which fuses them under ``jit`` (it has no Pallas kernel
for them); eager PyTorch runs each as a launch of its own over the whole
batch.  On a CUDA tensor ``sym_eig3_smallest`` / ``sym_eig2_smallest``
therefore launch ``csrc/sym_eig.cu``, written by hand for Hopper: one thread
per matrix through ``csrc/sym_eig.cuh``, the same device function that is the
epilogue of ``csrc/radius_pca.cu``.  What bounds it on an H100: bytes (a
matrix read, ``2 D`` floats written, against some 150 operations); it reads
and writes each once.

``sym_eig3_plain`` / ``sym_eig2_plain`` are the closed forms in ordinary
tensor operations: the plain version, taken for CPU tensors, by the tests
and by the on-card comparison.  A CUDA tensor never takes them from the
wrappers: the kernel launches or the call raises.  The kernel follows them
formula for formula but not bit for bit (``acosf`` / ``cosf`` differ from
PyTorch's by ulps and ``nvcc`` contracts products and sums into FMAs).
"""
from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

__all__ = ["sym_eig3_smallest", "sym_eig2_smallest", "sym_eig3_plain",
           "sym_eig2_plain"]


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion (elementwise)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def sym_eig3_plain(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sym_eig3_smallest` in ordinary tensor operations, on whatever
    device ``A`` lies."""
    q = (A[..., 0, 0] + A[..., 1, 1] + A[..., 2, 2]) / 3.0
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - q[..., None, None] * eye
    p2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    detB = _det3(B / p[..., None, None])
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    two_pi_3 = 2.0 * math.pi / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)                 # largest
    l0 = q + 2.0 * p * torch.cos(phi + two_pi_3)      # smallest
    l1 = 3.0 * q - l0 - l2
    evals = torch.stack([l0, l1, l2], dim=-1)

    C = (A - l1[..., None, None] * eye) @ (A - l2[..., None, None] * eye)
    norms = torch.sum(C * C, dim=-2)  # [..., 3] column norms^2
    best = torch.argmax(norms, dim=-1)
    idx = best[..., None, None].expand(*C.shape[:-1], 1)
    v = torch.gather(C, -1, idx)[..., 0]
    vn = torch.linalg.norm(v, dim=-1, keepdim=True)
    degenerate = (vn[..., 0] < 1e-12) | (p < 1e-12)
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    v = torch.where(degenerate[..., None], fallback,
                    v / torch.clamp(vn, min=1e-30))
    return evals, v


def sym_eig2_plain(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`sym_eig2_smallest` in ordinary tensor operations, on whatever
    device ``A`` lies."""
    a = A[..., 0, 0]
    b = A[..., 0, 1]
    c = A[..., 1, 1]
    tr = a + c
    d = torch.sqrt(torch.clamp((a - c) ** 2 + 4 * b * b, min=0.0))
    l0 = (tr - d) / 2.0
    l1 = (tr + d) / 2.0
    evals = torch.stack([l0, l1], dim=-1)
    theta = 0.5 * torch.atan2(2 * b, a - c)  # principal (largest) direction
    v = torch.stack([-torch.sin(theta), torch.cos(theta)], dim=-1)
    return evals, v


def _eig_kernel(A: torch.Tensor, dim: int):
    """Launch ``csrc/sym_eig.cu`` on the current stream."""
    from ._build import load
    if A.shape[-2:] != (dim, dim):
        raise ValueError(f"sym_eig kernel: expected [..., {dim}, {dim}]; got "
                         f"{tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise ValueError("sym_eig kernel needs float32 matrices")
    if not A.is_cuda:
        raise ValueError("kernel launch needs CUDA tensors")
    batch = A.shape[:-2]
    cov = A.reshape(-1, dim, dim).contiguous()
    n = cov.shape[0]
    evals = torch.empty((n, dim), dtype=torch.float32, device=A.device)
    normal = torch.empty((n, dim), dtype=torch.float32, device=A.device)
    if n > 0:
        lib = load("sym_eig")
        fn = lib.sym_eig_smallest_launch
        if not getattr(fn, "_typed", False):
            vp, ci = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [vp, ci, ci, vp, vp, vp]
            fn.restype = ci
            fn._typed = True
        with torch.cuda.device(A.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(cov.data_ptr(), n, dim, evals.data_ptr(),
                     normal.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"sym_eig kernel launch failed (code {err})")
        (sym_eig3_smallest if dim == 3 else sym_eig2_smallest).launches += 1
    return evals.reshape(*batch, dim), normal.reshape(*batch, dim)


def sym_eig3_smallest(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-eigenvalue eigenvector of symmetric A [..., 3, 3].

    Returns ``(eigenvalues [..., 3] ascending, eigenvector [..., 3])``.
    Degenerate (isotropic) neighborhoods fall back to +z.  A CUDA ``A``
    launches the hand-written kernel (or raises); a CPU ``A`` runs
    :func:`sym_eig3_plain`.
    """
    return _eig_kernel(A, 3) if A.is_cuda else sym_eig3_plain(A)


def sym_eig2_smallest(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-eigenvalue eigenvector of symmetric A [..., 2, 2]; a CUDA
    ``A`` launches the hand-written kernel (or raises), a CPU ``A`` runs
    :func:`sym_eig2_plain`."""
    return _eig_kernel(A, 2) if A.is_cuda else sym_eig2_plain(A)


# kernel launches of each wrapper (the plain path adds none)
sym_eig3_smallest.launches = 0
sym_eig2_smallest.launches = 0
