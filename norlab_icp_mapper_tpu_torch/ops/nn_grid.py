"""Exact 1-NN through a uniform cell grid: the ICP matcher without maxDist.

The brute-force search (``ops/nn.py``) computes the distance from every
query to every reference; at the default mapper's size that is ~15 Gpairs a
matcher pass, nearly all of them metres away from the query.  The reference
mapper asks a libnabo kd-tree instead.  Here the references are sorted into
a grid of cells once per change of the map (:func:`build_grid_pack`), and a
query visits the cells around its own, shell by shell, until no unvisited
cell can hold a reference as near as the best found (the rule and its
rounding margin are derived in ``csrc/knn_grid.cu``).  The answer is the
brute-force answer bit for bit: the same subtract-first f32 squared
distance, and among equal distances the lowest index (``knn_plain``'s tie
rule).  A query that is not resolved within ``SHELL_CAP`` shells, or whose
coordinates are not finite, goes to the brute-force kernel, on a list built
on the device: the search is exact whatever the cloud.

The kernel
----------
On a CUDA tensor :func:`knn_grid` launches ``csrc/knn_grid.cu``, then
``csrc/knn_brute.cu`` on the fallback's list (sized by N on the host, it
leaves at once past the device count).  It replaces no Pallas kernel: the
JAX package searches this matcher by brute force, which the port keeps as
``knn_brute.cu`` for every other caller.

* What bounds it on an H100: the latency of its gathers.  A query reads a
  row's bounds in the cell table, then the row's references; the arithmetic
  is a few dozen pairs a query, and the sorted map and the cell table stay
  in the 50 MB L2.
* What the design does about it: eight threads serve one query and
  split each shell's references, consecutive lanes on consecutive
  references; a chunk of rows' bounds is loaded in one step, one row per
  lane; the lanes join their running best, one 64-bit key
  ``(bits of d2 << 32) | index``, by shuffles.

On a CPU tensor :func:`knn_grid` runs :func:`knn_grid_plain`, the same
cells, shells, stopping rule and fallback in ordinary tensor operations;
the tests hold it against ``knn_plain`` and the card holds the kernel
against ``knn_brute``.  The matcher on the CPU runs ``knn_plain`` as before
(:func:`matcher_pack_kind`).

The pack's shapes come from the reference capacity alone (the solve graph's
buffers are static): ``C`` cells, a power of two; the edge and the grid's
dims are chosen on the device from the valid references' bounding box, with
no host read.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from .nn import KnnPack, _knn_kernel, knn_plain, pack_refs, query_rows
from .nn_sweep import _check_kernel_args

__all__ = ["GridPack", "build_grid_pack", "grid_cells", "knn_grid",
           "knn_grid_plain", "matcher_pack_kind", "SHELL_CAP"]

SHELL_CAP = 4  # shells searched before the fallback (the kernel's
# GRID_SHELL_CAP)
_CELLS_PER_ROW = 2  # cells per reference row of capacity, rounded up to 2^k
_MAX_CELLS = 1 << 24  # a cell index stays exact in f32
_EDGES = 256  # candidate edges tried by build_grid_pack
_ONE_MINUS = 1.0 - 2.0 ** -20  # exact in f32
_MARGIN = 2.0 ** -20
_MIN_BOUND = 1e-18  # B'^2 stays a normal f32 above this
_KEY_NONE = (0x7F800000 << 32) | 0xFFFFFFFF  # +inf, index -1


class GridPack(NamedTuple):
    """The references as the grid search reads them, built by
    :func:`build_grid_pack` once per change of the reference cloud.  The
    first three fields are the brute-force pack (``KnnPack``) of the same
    cloud, which the fallback searches."""
    ref4: torch.Tensor  # f32[M, 4] valid refs first, original order
    n_valid: torch.Tensor  # 0-d i64
    dim: int
    cell_ref4: torch.Tensor  # f32[M, 4] the finite valid refs by cell first
    cell_start: torch.Tensor  # i32[C + 1] first position of each cell
    grid_f: torch.Tensor  # f32[8] lo x, y, z, edge h, 1 / h, span, 0, 0
    grid_i: torch.Tensor  # i32[4] dims x, y, z, C

    def knn_pack(self) -> KnnPack:
        return KnnPack(self.ref4, self.n_valid, self.dim)


def matcher_pack_kind(max_dist: float, k: int, device: torch.device) -> str:
    """What the ICP matcher prepares for its reference: ``"sweep"`` with a
    finite ``maxDist``, ``"grid"`` for the unbounded 1-NN on a CUDA device,
    ``"brute"`` otherwise (k > 1, or the CPU, where ``knn_plain`` runs)."""
    if math.isfinite(max_dist):
        return "sweep"
    if k == 1 and torch.device(device).type == "cuda":
        return "grid"
    return "brute"


def grid_cells(capacity: int) -> int:
    """Cells of the grid of a reference buffer of ``capacity`` rows: a power
    of two, ``_CELLS_PER_ROW`` per row rounded up, at least 64."""
    c = 64
    while c < _CELLS_PER_ROW * capacity and c < _MAX_CELLS:
        c *= 2
    return c


def _edge(ext: torch.Tensor, cells: int):
    """``(h, 1 / h, dims)``: the smallest of ``_EDGES`` candidate edges,
    spaced evenly in log between ``emax / C`` and ``2 emax / (C^(1/3) -
    1)``, whose grid of ``floor(ext / h) + 1`` cells a side (``dims``, f32)
    has at most ``cells`` cells; an edge of 1 and one cell for a cloud of
    one point.  On the device, no host read."""
    dev = ext.device
    emax = ext.max()
    flat = emax <= 0
    e = torch.where(flat, torch.ones_like(emax), emax)
    lo = torch.log(e / cells)
    hi = torch.log(2.0 * e / (cells ** (1.0 / 3.0) - 1.0))
    t = torch.arange(_EDGES, dtype=torch.float32, device=dev) / (_EDGES - 1)
    cand = torch.exp(lo + t * (hi - lo))  # [E]
    inv = 1.0 / cand
    dims = torch.floor(ext[None, :] * inv[:, None]) + 1.0  # [E, 3]
    size = torch.clamp(dims, max=float(2 * _MAX_CELLS)).to(torch.float64)
    ok = (size.prod(1) <= cells) | (torch.arange(_EDGES, device=dev)
                                    == _EDGES - 1)
    pick = torch.argmax(ok.to(torch.int32)).reshape(1)  # the first that fits
    one = torch.ones((), dtype=torch.float32, device=dev)
    h = torch.where(flat, one, cand.index_select(0, pick).reshape(()))
    inv_h = torch.where(flat, one, inv.index_select(0, pick).reshape(()))
    dims = torch.where(flat, torch.ones_like(ext),
                       dims.index_select(0, pick).reshape(3))
    return h, inv_h, dims


def build_grid_pack(ref: torch.Tensor,
                    ref_mask: Optional[torch.Tensor]) -> GridPack:
    """The brute-force pack (:func:`pack_refs`), and its finite valid
    references sorted by cell (stable: original order inside a cell), the
    cell table and the grid's parameters.  Cell of a point on axis a:
    ``clamp(floor((p_a - lo_a) * inv_h), 0, dims_a - 1)``, row-major with
    x fastest.  Shapes from the capacity alone; nothing read on the host."""
    base = pack_refs(ref, ref_mask)
    m = ref.shape[0]
    dev = ref.device
    cells = grid_cells(m)
    xyz = base.ref4[:, :3]
    live = (torch.arange(m, device=dev) < base.n_valid) & \
        torch.isfinite(xyz).all(1)
    inf = float("inf")
    if m:
        lo = torch.where(live[:, None], xyz, inf).amin(0)
        hi = torch.where(live[:, None], xyz, -inf).amax(0)
    else:
        lo = torch.full((3,), inf, device=dev)
        hi = torch.full((3,), -inf, device=dev)
    lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
    hi = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))
    ext = torch.clamp(hi - lo, min=0.0, max=1e30)
    h, inv_h, dims = _edge(ext, cells)
    span = ext.max() + 2.0 * h
    cf = torch.floor((xyz - lo) * inv_h)
    cf = torch.minimum(torch.clamp(cf, min=0.0), dims - 1.0)
    ci = torch.where(live[:, None], cf, torch.zeros_like(cf)).to(torch.int64)
    di = dims.to(torch.int64)
    key = (ci[:, 2] * di[1] + ci[:, 1]) * di[0] + ci[:, 0]
    key = torch.where(live, key, torch.full_like(key, cells))
    key_s, order = torch.sort(key, stable=True)
    cell_start = torch.searchsorted(
        key_s, torch.arange(cells + 1, dtype=torch.int64, device=dev),
        out_int32=True)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    grid_f = torch.stack([lo[0], lo[1], lo[2], h, inv_h, span, zero, zero])
    grid_i = torch.cat([di.to(torch.int32),
                        torch.full((1,), cells, dtype=torch.int32,
                                   device=dev)])
    return GridPack(base.ref4, base.n_valid, base.dim,
                    base.ref4.index_select(0, order), cell_start, grid_f,
                    grid_i)


def _check_pack(pack: GridPack) -> None:
    if (pack.cell_ref4.ndim != 2 or pack.cell_ref4.shape[1] != 4
            or pack.cell_ref4.dtype != torch.float32
            or pack.cell_start.dtype != torch.int32
            or pack.grid_f.shape != (8,) or pack.grid_f.dtype != torch.float32
            or pack.grid_i.shape != (4,) or pack.grid_i.dtype != torch.int32):
        raise ValueError("knn_grid: the pack is not build_grid_pack's")


def knn_grid(query: torch.Tensor, query_mask: Optional[torch.Tensor],
             pack: GridPack, stats: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The nearest reference of every valid query: ``(d2 f32[N, 1],
    idx i64[N, 1])``, ``inf`` / ``-1`` for a masked query or an empty
    reference, exactly as ``knn(query, ref, query_mask, ref_mask, k=1)``.
    ``stats`` (i64[2]) gets the valid queries and the fallback's queries
    added.  A CUDA ``query`` launches the kernels (or raises); a CPU
    ``query`` runs :func:`knn_grid_plain`."""
    _check_pack(pack)
    if not query.is_cuda:
        d2, idx, fallbacks = knn_grid_plain(query, query_mask, pack)
        if stats is not None:
            n_q = (query.shape[0] if query_mask is None
                   else int(query_mask.sum()))
            stats += torch.tensor([n_q, fallbacks], dtype=torch.int64)
        return d2, idx
    query = query.contiguous()
    qrows = query_rows(query_mask)
    d2, idx, fb_list, fb_count = _grid_kernel(query, qrows, pack, stats)
    # the fallback: the listed rows against the whole pack
    _knn_kernel(query, (fb_list, fb_count), pack.knn_pack(), 1,
                out=(d2, idx))
    return d2, idx


def _grid_kernel(query, qrows, pack: GridPack, stats=None):
    """Launch ``csrc/knn_grid.cu`` on the current stream: ``(d2, idx,
    fb_list, fb_count)``, every row written but those listed in ``fb_list``
    before the count ``fb_count`` (0-d i64), which the fallback fills.
    ``qrows`` is ``query_rows`` of the query mask."""
    from ._build import load
    n, dim = query.shape
    if dim != pack.dim or dim not in (2, 3):
        raise ValueError(f"knn_grid: queries of D={dim} against a pack of "
                         f"D={pack.dim}")
    if query.dtype != torch.float32:
        raise ValueError("knn_grid needs float32 coordinates")
    if stats is not None and (stats.shape != (2,)
                              or stats.dtype != torch.int64):
        raise ValueError("knn_grid: stats is i64[2]")
    dev = query.device
    d_out = torch.empty((n, 1), dtype=torch.float32, device=dev)
    i_out = torch.empty((n, 1), dtype=torch.int64, device=dev)
    fb_list = torch.empty(n, dtype=torch.int32, device=dev)
    fb_count = torch.zeros((), dtype=torch.int64, device=dev)
    tensors = [query, pack.cell_ref4, pack.cell_start, pack.grid_f,
               pack.grid_i, d_out, i_out, fb_list, fb_count]
    if qrows is not None:
        tensors += list(qrows)
    if stats is not None:
        tensors.append(stats)
    _check_kernel_args(*tensors)
    if n == 0:
        return d_out, i_out, fb_list, fb_count
    ref4 = pack.cell_ref4
    if ref4.shape[0] == 0:
        ref4 = query.new_zeros((1, 4))  # never read, the pointer is valid
    fn = load("knn_grid").knn_grid_launch
    if not getattr(fn, "_typed", False):
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, ci, vp, vp, vp, vp, vp, vp, ci, vp, vp, vp, vp,
                       vp, vp]
        fn.restype = ci
        fn._typed = True
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(query.data_ptr(), dim,
                 None if qrows is None else qrows[0].data_ptr(),
                 None if qrows is None else qrows[1].data_ptr(),
                 ref4.data_ptr(), pack.cell_start.data_ptr(),
                 pack.grid_f.data_ptr(), pack.grid_i.data_ptr(), n,
                 d_out.data_ptr(), i_out.data_ptr(), fb_list.data_ptr(),
                 fb_count.data_ptr(),
                 None if stats is None else stats.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"knn_grid kernel launch failed (code {err})")
    knn_grid.launches += 1
    knn_grid.launches_by_shape[dim] = knn_grid.launches_by_shape.get(dim,
                                                                     0) + 1
    return d_out, i_out, fb_list, fb_count


knn_grid.launches = 0  # grid kernel launches (the plain path adds none)
knn_grid.launches_by_shape = {}  # D -> launches


def _shell_ranges(cs, c, dims, s):
    """The sorted-reference ranges of shell ``s`` around the cells ``c``
    ([A, 3] int64): ``(start, end)`` of [A, R, 2], the two segments of each
    of the shell's R rows (empty where the row leaves the grid), as the
    kernel's ``shell_row`` gives them."""
    dev = c.device
    w = 2 * s + 1
    r = torch.arange(w * w, device=dev)
    dz, dy = r // w - s, r % w - s
    full = (dy.abs() == s) | (dz.abs() == s)  # [R]
    nx, ny, nz = dims
    y = c[:, 1:2] + dy[None]  # [A, R]
    z = c[:, 2:3] + dz[None]
    inside = (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
    base = (z.clamp(0, nz - 1) * ny + y.clamp(0, ny - 1)) * nx
    cx = c[:, 0:1]
    # full rows: [max(cx - s, 0), min(cx + s, nx - 1)]; others: the cells
    # cx - s and cx + s where they exist
    lo0 = torch.where(full[None], torch.clamp(cx - s, min=0), cx - s)
    hi0 = torch.where(full[None], torch.clamp(cx + s, max=nx - 1), cx - s)
    ok0 = inside & (lo0 >= 0) & (hi0 <= nx - 1)
    lo1 = hi1 = (cx + s).expand_as(y)
    ok1 = inside & ~full[None] & (lo1 <= nx - 1)

    def rng(lo, hi, ok):
        a = cs[(base + lo.clamp(0, nx - 1)).reshape(-1)].reshape(lo.shape)
        b = cs[(base + hi.clamp(0, nx - 1) + 1).reshape(-1)].reshape(lo.shape)
        a = torch.where(ok, a, torch.zeros_like(a))
        b = torch.where(ok, b, torch.zeros_like(b))
        return a, b
    a0, b0 = rng(lo0, hi0, ok0)
    a1, b1 = rng(lo1, hi1, ok1)
    return torch.stack([a0, a1], -1), torch.stack([b0, b1], -1)


def knn_grid_plain(query: torch.Tensor, query_mask: Optional[torch.Tensor],
                   pack: GridPack, shell_cap: int = SHELL_CAP):
    """The kernels' function in plain tensor operations, on whatever device
    the tensors lie: each valid query's cell, its shells, the 64-bit key
    minimum, the stopping rule with its margin, and the fallback through
    ``knn_plain`` for what the shells leave unresolved.  Returns ``(d2
    f32[N, 1], idx i64[N, 1], fallbacks)``, ``fallbacks`` the number of
    queries the fallback searched (the kernel's count).  Reads counts on the
    host; for the tests and the on-card comparison."""
    n, dim = query.shape
    dev = query.device
    f32 = torch.float32
    d_out = torch.full((n, 1), float("inf"), dtype=f32, device=dev)
    i_out = torch.full((n, 1), -1, dtype=torch.int64, device=dev)
    q3 = torch.zeros((n, 3), dtype=f32, device=dev)
    q3[:, :dim] = query
    valid = (torch.ones(n, dtype=torch.bool, device=dev)
             if query_mask is None else query_mask)
    rows = torch.nonzero(valid).reshape(-1)
    finite = torch.isfinite(q3[rows]).all(1)
    lo, h, inv_h, span = (pack.grid_f[:3], pack.grid_f[3], pack.grid_f[4],
                          pack.grid_f[5])
    dims = [int(v) for v in pack.grid_i[:3].tolist()]
    dims_f = torch.tensor(dims, dtype=f32, device=dev)
    act = rows[finite]
    rel = q3[act] - lo
    cf = torch.minimum(torch.clamp(torch.floor(rel * inv_h), min=0.0),
                       dims_f - 1.0)
    c = cf.to(torch.int64)
    margin = (span + rel.abs().amax(1)) * _MARGIN
    key = torch.full((act.shape[0],), _KEY_NONE, dtype=torch.int64,
                     device=dev)
    cs = pack.cell_start.to(torch.int64)
    ref4 = pack.cell_ref4
    ids = ref4.view(torch.int32)[:, 3].to(torch.int64)
    live = torch.arange(act.shape[0], device=dev)  # positions in `act`
    for s in range(shell_cap + 1):
        if live.numel() == 0:
            break
        qa, ca = q3[act[live]], c[live]
        a, b = _shell_ranges(cs, ca, dims, s)  # [A, R, 2]
        lens = (b - a).reshape(-1)
        seg_q = torch.arange(live.numel(), device=dev).repeat_interleave(
            a.shape[1] * 2)
        total = int(lens.sum())
        if total:
            starts = torch.cumsum(lens, 0) - lens
            owner = torch.repeat_interleave(
                torch.arange(lens.numel(), device=dev), lens)
            pos = a.reshape(-1)[owner] + torch.arange(total, device=dev) \
                - starts[owner]
            who = seg_q[owner]
            r = ref4[pos]
            qq = qa[who]
            d = r[:, 0] - qq[:, 0]
            d2 = d * d
            d = r[:, 1] - qq[:, 1]
            d2 = d2 + d * d
            d = r[:, 2] - qq[:, 2]
            d2 = d2 + d * d
            k = (d2.view(torch.int32).to(torch.int64) << 32) | ids[pos]
            sub = key[live].scatter_reduce(0, who, k, "amin")
            key[live] = sub
        # the lower bound on the distance to every unvisited reference
        ra = rel[live]
        bound = torch.full((live.numel(),), float("inf"), dtype=f32,
                           device=dev)
        covered = torch.ones(live.numel(), dtype=torch.bool, device=dev)
        for ax in range(3):
            low = ca[:, ax] - s - 1 >= 0
            high = ca[:, ax] + s + 1 <= dims[ax] - 1
            b_lo = ra[:, ax] - (ca[:, ax] - s).to(f32) * h
            b_hi = (ca[:, ax] + s + 1).to(f32) * h - ra[:, ax]
            bound = torch.where(low, torch.minimum(bound, b_lo), bound)
            bound = torch.where(high, torch.minimum(bound, b_hi), bound)
            covered = covered & ~low & ~high
        best = (key[live] >> 32).to(torch.int32).view(f32)
        bb = bound - margin[live]
        done = covered | ((bb >= _MIN_BOUND)
                          & (best < (bb * bb) * _ONE_MINUS))
        live = live[~done]
    resolved = torch.ones(act.shape[0], dtype=torch.bool, device=dev)
    resolved[live] = False
    best = (key >> 32).to(torch.int32).view(f32)
    found = resolved & (best < float("inf"))
    idx = torch.where(found, key & 0xFFFFFFFF, torch.full_like(key, -1))
    d_out[act[resolved], 0] = torch.where(found, best,
                                          torch.full_like(best,
                                                          float("inf")))[
        resolved]
    i_out[act[resolved], 0] = idx[resolved]
    fb = torch.cat([act[live], rows[~finite]])
    if fb.numel():
        m = int(pack.n_valid)
        d_f, p_f = knn_plain(query[fb], pack.ref4[:m, :dim], k=1)
        ids0 = pack.ref4.view(torch.int32)[:m, 3].to(torch.int64)
        if m:
            p_f = torch.where(p_f >= 0, ids0[torch.clamp(p_f, min=0)], p_f)
        d_out[fb] = d_f
        i_out[fb] = p_f
    return d_out, i_out, int(fb.numel())
