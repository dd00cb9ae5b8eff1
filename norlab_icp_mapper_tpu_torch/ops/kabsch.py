"""Point-to-point ICP on the card: from the matched pairs to the rigid
increment (``csrc/kabsch.cu``).

The JAX package's point-to-point minimizer reduces the weighted pairs to the
centred cross-covariance ``H = sum w (p - mu_p)(q - mu_q)^T`` and the two
weighted means, then takes ``U, S, V^T = svd(H)``, ``R = V diag(1, ..,
det(V U^T)) U^T`` and ``t = mu_q - R mu_p`` inside its ``lax.while_loop``
(``icp/engine.py:547-560``, ``parallel/sharded_map.py:790-806``; XLA's SVD,
no Pallas kernel).  ``torch.linalg.svd`` and ``det`` on a CUDA tensor make
the host wait for the card, so they cannot sit inside a CUDA graph; the
port computes the same rotation with kernels of its own.

:func:`p2p_step` goes from the pairs ``p [N, D]``, ``q [N, k, D]``, ``w [N,
k]`` to ``dT`` and the rms in one launch: float64 moments of the pairs in
one pass (``sum w``, ``sum w p``, ``sum w q``, ``sum w p q^T``, ``sum w
|p - q|^2``; centred float32 sums cancel badly at a hall's 60 m
coordinates), summed over the blocks by the last block to finish (in block
order, no float atomics: deterministic), which then forms, in float64,
``wsum = max(sum w, 1e-9)``, the means, ``H = S_pq - S_p S_q^T / wsum`` and
``rms = sqrt(sum w |p - q|^2 / wsum)``, and solves.  The sharded solve
splits it around its ``all_reduce``: :func:`p2p_moments` (the moments only,
the same kernel) and :func:`kabsch_from_moments`.  :func:`kabsch` solves
from ``H`` and the means.

The solve: ``R`` maximises ``tr(R H)`` over proper rotations.
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

The kernels
-----------
Every product, sum, quotient and root is rounded on its own
(``__fmul_rn`` / ``__dadd_rn`` / ...), in the order the plain versions take
them: the solve (:func:`kabsch_plain`, :func:`solve_moments_plain`) agrees
bit for bit, and so does each pair's share of the moments; the moments'
sums differ from :func:`p2p_moments_plain` only in their order (within
1e-12 of the sums' absolute size).  What bounds them on an H100 is the
launch and the last block's serial tail: the pairs are 1.4 MB at the
reading's capacity, the solve ~3k f32 operations.  The counters are per
kernel: ``p2p_step.launches`` counts the pair reductions (fused or
moments-only), ``kabsch.launches`` the solves alone.

The plain versions are the CPU path and the tests' yardstick; a CUDA
tensor never takes them from a wrapper (the kernel launches or the call
raises).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

__all__ = ["kabsch", "kabsch_plain", "SWEEPS", "p2p_step", "p2p_step_plain",
           "p2p_moments", "p2p_moments_plain", "kabsch_from_moments",
           "solve_moments_plain", "n_moments"]

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


# --------------------------------------------------------------------------
# from the pairs: float64 moments, then the solve
# --------------------------------------------------------------------------

def n_moments(d: int) -> int:
    """Length of the moments vector: ``sum w``, ``sum w p`` (D), ``sum w
    q`` (D), ``sum w p q^T`` (D x D, row-major), ``sum w |p - q|^2``."""
    return 1 + 2 * d + d * d + 1


def _check_pairs(p, q, w) -> Tuple[int, int]:
    if p.dim() != 2 or p.shape[1] not in (2, 3):
        raise ValueError(f"p2p_step: p is [N, D] with D in (2, 3); got "
                         f"{tuple(p.shape)}")
    n, d = p.shape
    if q.dim() != 3 or q.shape[0] != n or q.shape[2] != d or q.shape[1] < 1:
        raise ValueError(f"p2p_step: q is [N, k, {d}]; got "
                         f"{tuple(q.shape)}")
    if w.shape != q.shape[:2]:
        raise ValueError(f"p2p_step: w is [N, k] = {tuple(q.shape[:2])}; "
                         f"got {tuple(w.shape)}")
    if not (p.dtype == q.dtype == w.dtype == torch.float32):
        raise ValueError("p2p_step: float32 inputs")
    if not (p.device == q.device == w.device):
        raise ValueError("p2p_step: inputs on one device")
    return d, q.shape[1]


def _check_moments(m, d) -> None:
    if d not in (2, 3) or m.dtype != torch.float64 or m.shape != (
            n_moments(d),):
        raise ValueError(f"kabsch_from_moments: float64 moments "
                         f"[{n_moments(d) if d in (2, 3) else 'M'}] of D in "
                         f"(2, 3); got {m.dtype} {tuple(m.shape)}, D={d}")


def p2p_moments_plain(p: torch.Tensor, q: torch.Tensor,
                      w: torch.Tensor) -> torch.Tensor:
    """The float64 moments of the weighted pairs (:func:`n_moments`), each
    pair's terms taken as the kernel takes them."""
    d, _ = _check_pairs(p, q, w)
    w64, q64 = w.double(), q.double()
    p64 = p.double()[:, None, :]
    wp = w64[..., None] * p64  # [N, k, D]
    spq = (wp[..., :, None] * q64[..., None, :]).sum((0, 1))  # [D, D]
    dx = p64 - q64
    e = dx[..., 0] * dx[..., 0]
    for i in range(1, d):
        e = e + dx[..., i] * dx[..., i]
    return torch.cat([w64.sum()[None], wp.sum((0, 1)),
                      (w64[..., None] * q64).sum((0, 1)), spq.reshape(-1),
                      (w64 * e).sum()[None]])


def _from_moments(m: torch.Tensor, d: int):
    """``(H, mu_p, mu_q, rms)`` in float32 from float64 moments."""
    wsum = torch.clamp(m[0], min=1e-9)
    sp, sq = m[1:1 + d], m[1 + d:1 + 2 * d]
    spq = m[1 + 2 * d:1 + 2 * d + d * d].reshape(d, d)
    H = spq - torch.outer(sp, sq) / wsum
    return (H.float(), (sp / wsum).float(), (sq / wsum).float(),
            torch.sqrt(m[-1] / wsum).float())


def solve_moments_plain(m: torch.Tensor, d: int):
    """:func:`kabsch_from_moments` in tensor operations: ``(dT, rms)``."""
    _check_moments(m, d)
    H, mu_p, mu_q, rms = _from_moments(m, d)
    return kabsch_plain(H, mu_p, mu_q), rms


def p2p_step_plain(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """:func:`p2p_step` in tensor operations: ``(dT, rms)``."""
    d, _ = _check_pairs(p, q, w)
    return solve_moments_plain(p2p_moments_plain(p, q, w), d)


_tickets: Dict[tuple, torch.Tensor] = {}  # (device, stream) -> counter


def _ticket(device, stream: int) -> torch.Tensor:
    """The zeroed counter of the last-block sum for launches on ``stream``
    (the kernel leaves it zeroed; two streams never share one)."""
    key = (device, stream)
    t = _tickets.get(key)
    if t is None:
        t = _tickets[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return t


def _p2p_kernel(p, q, w, solve: bool):
    from ._build import load
    d, k = _check_pairs(p, q, w)
    p, q, w = p.contiguous(), q.contiguous(), w.contiguous()
    n, dev = p.shape[0], p.device
    lib = load("kabsch")
    if not getattr(lib, "_p2p_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.p2p_step_blocks.argtypes = [ci]
        lib.p2p_step_blocks.restype = ci
        lib.p2p_step_launch.argtypes = [vp, vp, vp, ci, ci, ci, vp, vp, vp,
                                        ci, vp, vp, vp]
        lib.p2p_step_launch.restype = ci
        lib._p2p_typed = True
    partials = torch.empty((lib.p2p_step_blocks(n), n_moments(d)),
                           dtype=torch.float64, device=dev)
    moments = torch.empty(n_moments(d), dtype=torch.float64, device=dev)
    dT = torch.empty((d + 1, d + 1), dtype=torch.float32, device=dev)
    rms = torch.empty((), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        ticket = _ticket(dev, stream)
        err = lib.p2p_step_launch(p.data_ptr(), q.data_ptr(), w.data_ptr(),
                                  n, k, d, partials.data_ptr(),
                                  ticket.data_ptr(), moments.data_ptr(),
                                  int(solve), dT.data_ptr(), rms.data_ptr(),
                                  stream)
    if err != 0:
        raise RuntimeError(f"p2p_step kernel launch failed (code {err})")
    p2p_step.launches += 1
    p2p_step.launches_by_shape[(d, k)] = \
        p2p_step.launches_by_shape.get((d, k), 0) + 1
    return moments, dT, rms


def p2p_step(p: torch.Tensor, q: torch.Tensor, w: torch.Tensor):
    """The point-to-point increment of the weighted pairs ``p [N, D]``,
    ``q [N, k, D]``, ``w [N, k]`` (float32, ``D`` = 2 or 3): ``(dT [D+1,
    D+1], rms)``, the JAX package's SVD form.  CUDA inputs launch
    ``csrc/kabsch.cu`` once (or raise); CPU inputs run
    :func:`p2p_step_plain`."""
    if not p.is_cuda:
        return p2p_step_plain(p, q, w)
    _, dT, rms = _p2p_kernel(p, q, w, solve=True)
    return dT, rms


p2p_step.launches = 0  # pair reductions launched (fused or moments only)
p2p_step.launches_by_shape = {}  # (D, k) -> launches


def p2p_moments(p: torch.Tensor, q: torch.Tensor,
                w: torch.Tensor) -> torch.Tensor:
    """The float64 moments of the pairs (:func:`n_moments`), for a sum over
    ranks before :func:`kabsch_from_moments`.  CUDA inputs launch the
    ``p2p_step`` kernel with its solve off (counted on
    ``p2p_step.launches``); CPU inputs run :func:`p2p_moments_plain`."""
    if not p.is_cuda:
        return p2p_moments_plain(p, q, w)
    return _p2p_kernel(p, q, w, solve=False)[0]


def kabsch_from_moments(m: torch.Tensor, d: int):
    """``(dT, rms)`` from float64 moments ``m`` (as :func:`p2p_moments`
    writes them, summed over ranks).  CUDA inputs launch the ``kabsch``
    kernel (counted on ``kabsch.launches``); CPU inputs run
    :func:`solve_moments_plain`."""
    if not m.is_cuda:
        return solve_moments_plain(m, d)
    from ._build import load
    _check_moments(m, d)
    m = m.contiguous()
    lib = load("kabsch")
    fn = lib.kabsch_moments_launch
    if not getattr(fn, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, ci, vp, vp, vp]
        fn.restype = ci
        fn._typed = True
    dT = torch.empty((d + 1, d + 1), dtype=torch.float32, device=m.device)
    rms = torch.empty((), dtype=torch.float32, device=m.device)
    with torch.cuda.device(m.device):
        err = fn(m.data_ptr(), 1, d, dT.data_ptr(), rms.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kabsch kernel launch failed (code {err})")
    kabsch.launches += 1
    kabsch.launches_by_shape[(d,)] = kabsch.launches_by_shape.get((d,), 0) + 1
    return dT, rms
