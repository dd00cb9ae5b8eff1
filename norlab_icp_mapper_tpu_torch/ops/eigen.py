"""Closed-form symmetric eigensolvers for tiny batched matrices.

The surface-normal pass needs one 3x3 (or 2x2) symmetric eigensolve per map
point.  ``torch.linalg.eigh`` on [N, 3, 3] goes through an iterative batched
solver; these are the analytic alternatives, plain elementwise tensor math.

3x3: trigonometric (Cardano) eigenvalues + eigenvector from the product
``(A - l1 I)(A - l2 I)`` whose columns span the l0 eigenspace.
2x2: direct angle form.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

__all__ = ["sym_eig3_smallest", "sym_eig2_smallest"]


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of [..., 3, 3] by cofactor expansion (elementwise)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def sym_eig3_smallest(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-eigenvalue eigenvector of symmetric A [..., 3, 3].

    Returns ``(eigenvalues [..., 3] ascending, eigenvector [..., 3])``.
    Degenerate (isotropic) neighborhoods fall back to +z.
    """
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


def sym_eig2_smallest(A: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest-eigenvalue eigenvector of symmetric A [..., 2, 2]."""
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
