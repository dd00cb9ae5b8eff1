"""Weighted Kabsch on the card: the rigid increment of a point-to-point step.

The JAX package's point-to-point minimizer reduces the weighted pairs to the
centred cross-covariance ``H = sum w (p - mu_p)(q - mu_q)^T`` and the two
weighted means, then takes ``U, S, V^T = svd(H)``, ``R = V diag(1, ..,
det(V U^T)) U^T`` and ``t = mu_q - R mu_p`` inside its ``lax.while_loop``
(``icp/engine.py:547-560``, ``parallel/sharded_map.py:790-806``; XLA's SVD,
no Pallas kernel).  ``torch.linalg.svd`` and ``det`` on a CUDA tensor make
the host wait for the card, so they cannot sit inside a CUDA graph; the
port computes the same rotation with a kernel of its own.

The form: ``R`` maximises ``tr(R H)`` over proper rotations.
  * 3-D: Horn's quaternion -- the eigenvector of the largest eigenvalue of
    the symmetric 4x4 matrix ``N(H)`` -- found by cyclic Jacobi with a fixed
    number of sweeps (``SWEEPS``).  The rotation comes out proper by
    construction (the reflection case of the SVD form included), and its
    diagonal is written ``1 - 2(y^2 + z^2)``, so increments of 1e-4 rad keep
    their digits.  The closed-form eigenvectors of ``H^T H`` are not used:
    for clustered eigenvalues they lose orthogonality.
  * 2-D: ``theta = atan2(H01 - H10, H00 + H11)``, its cosine and sine taken
    as the normalised pair itself (no trigonometric call).
A rank-1 ``H`` (collinear pairs) leaves the rotation about the line free,
in the SVD form as here.

The kernel
----------
On a CUDA tensor :func:`kabsch` launches ``csrc/kabsch.cu``: one thread per
problem, everything in registers.  The solve needs one problem per
iteration, so what bounds it on an H100 is the launch itself; the work (~3k
f32 operations) and the bytes (``D^2 + 2D`` floats in, ``(D+1)^2`` out) are
far below a microsecond.  Every product, sum, quotient and root is rounded
on its own (``__fmul_rn`` / ``__fadd_rn`` / ``__fdiv_rn`` / ``__fsqrt_rn``),
in the order :func:`kabsch_plain` takes them, so kernel and plain version
agree bit for bit.

:func:`kabsch_plain` is that arithmetic in ordinary tensor operations: the
CPU path and the tests use it; a CUDA tensor never takes it from
:func:`kabsch` (the kernel launches or the call raises).
"""
from __future__ import annotations

import ctypes

import torch

__all__ = ["kabsch", "kabsch_plain", "SWEEPS"]

SWEEPS = 5  # cyclic Jacobi sweeps of the 4x4 (converged in f32 after 3)
_PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))


def _check(H: torch.Tensor, mu_p: torch.Tensor, mu_q: torch.Tensor) -> int:
    d = H.shape[-1]
    if d not in (2, 3) or H.shape[-2] != d:
        raise ValueError(f"kabsch: H is [..., D, D] with D in (2, 3); got "
                         f"{tuple(H.shape)}")
    if mu_p.shape != H.shape[:-1] or mu_q.shape != H.shape[:-1]:
        raise ValueError(f"kabsch: means are [..., {d}]; got "
                         f"{tuple(mu_p.shape)}, {tuple(mu_q.shape)}")
    if not (H.dtype == mu_p.dtype == mu_q.dtype == torch.float32):
        raise ValueError("kabsch: float32 inputs")
    if not (H.device == mu_p.device == mu_q.device):
        raise ValueError("kabsch: inputs on one device")
    return d


def _rotation_2d(H):
    a = H[..., 0, 0] + H[..., 1, 1]
    b = H[..., 0, 1] - H[..., 1, 0]
    r = torch.sqrt(a * a + b * b)
    flat = r == 0
    one = torch.ones_like(r)
    c = torch.where(flat, one, a / torch.where(flat, one, r))
    s = torch.where(flat, torch.zeros_like(r), b / torch.where(flat, one, r))
    return [[c, -s], [s, c]]


def _rotation_3d(H):
    S = [[H[..., i, j] for j in range(3)] for i in range(3)]
    (xx, xy, xz), (yx, yy, yz), (zx, zy, zz) = S
    # Horn's symmetric matrix; its top eigenvector is the quaternion
    # (w, x, y, z) of the R with R p ~ q
    N = [[(xx + yy) + zz, yz - zy, zx - xz, xy - yx],
         [None, (xx - yy) - zz, xy + yx, zx + xz],
         [None, None, (yy - xx) - zz, yz + zy],
         [None, None, None, (zz - xx) - yy]]
    for i in range(4):
        for j in range(i):
            N[i][j] = N[j][i]
    zero, one = torch.zeros_like(xx), torch.ones_like(xx)
    # V's columns as lists of rows: V[col][row]
    V = [[one if r == c else zero for r in range(4)] for c in range(4)]
    for _ in range(SWEEPS):
        for p, q in _PAIRS:
            apq, app, aqq = N[p][q], N[p][p], N[q][q]
            tau = (aqq - app) / (apq + apq)
            sgn = torch.where(tau >= 0, one, -one)
            t = sgn / (torch.abs(tau) + torch.sqrt(one + tau * tau))
            t = torch.where(apq == 0, zero, t)
            c = one / torch.sqrt(one + t * t)
            s = t * c
            tapq = t * apq
            N[p][p] = app - tapq
            N[q][q] = aqq + tapq
            N[p][q] = N[q][p] = zero
            for r in range(4):
                if r in (p, q):
                    continue
                arp, arq = N[r][p], N[r][q]
                N[r][p] = N[p][r] = c * arp - s * arq
                N[r][q] = N[q][r] = s * arp + c * arq
            for r in range(4):
                vrp, vrq = V[p][r], V[q][r]
                V[p][r] = c * vrp - s * vrq
                V[q][r] = s * vrp + c * vrq
    # the column of the largest eigenvalue (the first on ties)
    best, w = N[0][0], list(V[0])
    for col in range(1, 4):
        m = N[col][col] > best
        best = torch.where(m, N[col][col], best)
        w = [torch.where(m, V[col][r], w[r]) for r in range(4)]
    nrm = torch.sqrt(((w[0] * w[0] + w[1] * w[1]) + w[2] * w[2])
                     + w[3] * w[3])
    qw, qx, qy, qz = (x / nrm for x in w)
    two = one + one
    xx2, yy2, zz2 = qx * qx, qy * qy, qz * qz
    xy2, xz2, yz2 = qx * qy, qx * qz, qy * qz
    wx, wy, wz = qw * qx, qw * qy, qw * qz
    return [[one - two * (yy2 + zz2), two * (xy2 - wz), two * (xz2 + wy)],
            [two * (xy2 + wz), one - two * (xx2 + zz2), two * (yz2 - wx)],
            [two * (xz2 - wy), two * (yz2 + wx), one - two * (xx2 + yy2)]]


def kabsch_plain(H: torch.Tensor, mu_p: torch.Tensor,
                 mu_q: torch.Tensor) -> torch.Tensor:
    """:func:`kabsch` in ordinary tensor operations, on whatever device the
    inputs lie: ``dT [..., D+1, D+1]`` with ``R`` the proper rotation that
    maximises ``tr(R H)`` and ``t = mu_q - R mu_p``."""
    d = _check(H, mu_p, mu_q)
    R = _rotation_3d(H) if d == 3 else _rotation_2d(H)
    t = []
    for i in range(d):
        acc = R[i][0] * mu_p[..., 0]
        for j in range(1, d):
            acc = acc + R[i][j] * mu_p[..., j]
        t.append(mu_q[..., i] - acc)
    zero = torch.zeros_like(t[0])
    one = torch.ones_like(t[0])
    rows = [torch.stack(R[i] + [t[i]], dim=-1) for i in range(d)]
    rows.append(torch.stack([zero] * d + [one], dim=-1))
    return torch.stack(rows, dim=-2)


def _kernel(H, mu_p, mu_q, d):
    from ._build import load
    batch = H.shape[:-2]
    h = H.reshape(-1, d * d).contiguous()
    mp = mu_p.reshape(-1, d).contiguous()
    mq = mu_q.reshape(-1, d).contiguous()
    n = h.shape[0]
    out = torch.empty((n, d + 1, d + 1), dtype=torch.float32,
                      device=H.device)
    if n > 0:
        fn = load("kabsch").kabsch_launch
        if not getattr(fn, "_typed", False):
            vp, ci = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [vp, vp, vp, ci, ci, vp, vp]
            fn.restype = ci
            fn._typed = True
        with torch.cuda.device(H.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(h.data_ptr(), mp.data_ptr(), mq.data_ptr(), n, d,
                     out.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"kabsch kernel launch failed (code {err})")
        kabsch.launches += 1
        kabsch.launches_by_shape[(d,)] = \
            kabsch.launches_by_shape.get((d,), 0) + 1
    return out.reshape(*batch, d + 1, d + 1)


def kabsch(H: torch.Tensor, mu_p: torch.Tensor,
           mu_q: torch.Tensor) -> torch.Tensor:
    """The rigid increment ``dT [..., D+1, D+1]`` (``D`` = 2 or 3) from the
    centred weighted cross-covariance ``H [..., D, D]`` of the pairs
    ``(p, q)`` and their weighted means ``mu_p``, ``mu_q [..., D]``, all
    float32: the JAX package's SVD form.  CUDA inputs launch
    ``csrc/kabsch.cu`` (or raise); CPU inputs run :func:`kabsch_plain`."""
    d = _check(H, mu_p, mu_q)
    return _kernel(H, mu_p, mu_q, d) if H.is_cuda else kabsch_plain(
        H, mu_p, mu_q)


kabsch.launches = 0  # kernel launches (the plain path adds none)
kabsch.launches_by_shape = {}  # (D,) -> launches
