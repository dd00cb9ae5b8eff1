"""Plain nearest-neighbour searches, exact, in blocks of nearby queries.

The queries are taken in Morton order of a coarse grid, so that a block
of them covers a small box; a block is searched against the references
inside its box grown by the search's reach (the ``maxDist`` of a bounded
search; for an unbounded one, a reach that grows until every query's
``k``-th neighbour lies within it, which makes the result exact).

Within a block, candidates come from the expanded form
``|q|^2 + |r|^2 - 2 q.r`` (one matrix product, as ``torch.cdist``
computes it) about the references' mean, and the distances of the ``k +
EXTRA`` best candidates are then taken again from the coordinate
differences: the float32 rounding of the expanded form only decides which
candidates are looked at.  With TF32 matrix products (``tf32()``) that
step is what goes wrong first.
"""
from __future__ import annotations

import contextlib
import contextvars
import math

import torch

EXTRA = 8  # candidates beyond k, against the expanded form's rounding
BLOCK = 2048  # queries per block
CELL = 2.0  # m (rad in angle space): the grid the queries are ordered on

_TF32 = contextvars.ContextVar("tf32", default=False)


@contextlib.contextmanager
def tf32():
    """The reference's matrix products with TF32 inputs (10 bits of
    mantissa, rounded to nearest), as a card computes float32 products with
    TF32 switched on: the control's precision.  Emulated, so that it reads
    the same on the CPU."""
    token = _TF32.set(True)
    try:
        yield
    finally:
        _TF32.reset(token)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in float32, or with TF32 inputs inside ``tf32()``."""
    if _TF32.get():
        a, b = _round_tf32(a), _round_tf32(b)
    return a @ b


def _morton_order(p: torch.Tensor, cell: float) -> torch.Tensor:
    c = torch.floor((p - p.min(0).values) / cell).to(torch.int64)
    c = c.clamp(max=(1 << 16) - 1)
    key = torch.zeros(p.shape[0], dtype=torch.int64, device=p.device)
    d = p.shape[1]
    for bit in range(16):
        for a in range(d):
            key |= ((c[:, a] >> bit) & 1) << (bit * d + a)
    return torch.argsort(key)


def _blocks(query: torch.Tensor, block: int):
    order = _morton_order(query, CELL)
    for s in range(0, query.shape[0], block):
        rows = order[s:s + block]
        q = query[rows]
        yield rows, q, q.min(0).values, q.max(0).values


def _inside(ref, lo, hi, reach):
    return torch.nonzero(((ref >= lo - reach) & (ref <= hi + reach)).all(1)
                         ).squeeze(1)


def _candidates(q, r, centre, c):
    qc, rc = q - centre, r - centre
    d2 = (qc * qc).sum(1)[:, None] + (rc * rc).sum(1)[None, :] \
        - 2.0 * mm(qc, rc.T)
    return torch.topk(d2, min(c, r.shape[0]), dim=1, largest=False).indices


def knn(query: torch.Tensor, ref: torch.Tensor, k: int,
        max_dist: float = float("inf"), block: int = BLOCK):
    """``(d2 f32[N, k], idx i64[N, k])`` of the ``k`` nearest references of
    every query (ascending), ``idx = -1`` and ``d2 = inf`` where fewer than
    ``k`` lie within ``max_dist``.  Both clouds hold valid rows only."""
    n, m = query.shape[0], ref.shape[0]
    dev = query.device
    d_out = torch.full((n, k), float("inf"), device=dev)
    i_out = torch.full((n, k), -1, dtype=torch.int64, device=dev)
    if n == 0 or m == 0:
        return d_out, i_out
    centre = ref.mean(0)
    bounded = math.isfinite(max_dist)
    for rows, q, lo, hi in _blocks(query, block):
        reach = max_dist if bounded else 0.25
        while True:
            sel = _inside(ref, lo, hi, reach)
            if sel.shape[0]:
                cand = sel[_candidates(q, ref[sel], centre, k + EXTRA)]
                d2 = ((q[:, None, :] - ref[cand]) ** 2).sum(-1)
                d2, o = torch.sort(d2, dim=1)
                idx = torch.gather(cand, 1, o)[:, :k]
                d2 = d2[:, :k]
            if bounded or sel.shape[0] == m or (
                    sel.shape[0] >= k and bool((d2[:, -1] <= reach * reach)
                                               .all())):
                break
            reach *= 4.0
        if not sel.shape[0]:
            continue
        far = d2 > max_dist * max_dist
        kk = d2.shape[1]
        d_out[rows, :kk] = torch.where(far, torch.full_like(d2, float("inf")),
                                       d2)
        i_out[rows, :kk] = torch.where(far, torch.full_like(idx, -1), idx)
    return d_out, i_out


def radius_neighbours(points: torch.Tensor, radius: float,
                      k_max: int = 256, block: int = BLOCK):
    """Yields ``(rows, idx i64[B, K], inside bool[B, K])`` per block of
    ``points`` against themselves: every point within ``radius`` (``d <
    radius``) of each row is among its ``K`` listed ones; ``K`` doubles
    until no row of the block has all ``K`` inside."""
    centre = points.mean(0)
    for rows, q, lo, hi in _blocks(points, block):
        sel = _inside(points, lo, hi, radius)
        r = points[sel]
        kk = min(r.shape[0], k_max)
        while True:
            cand = sel[_candidates(q, r, centre, kk)]
            d2 = ((q[:, None, :] - points[cand]) ** 2).sum(-1)
            inside = d2 < radius * radius
            if kk == r.shape[0] or not bool(inside.all(1).any()):
                break
            kk = min(r.shape[0], 2 * kk)
        yield rows, cand, inside
