"""PointBatch: a fixed-capacity, validity-masked point cloud of tensors.

The counterpart of ``DataPoints`` in libpointmatcher and of the JAX
package's ``PointBatch``:

  - ``positions``   f32[capacity, dim]   (dim = 2 or 3)
  - ``mask``        bool[capacity]       (True = real point)
  - ``descriptors`` dict[str, f32[capacity, k]]  (e.g. ``normals`` [C, 3],
    ``probabilityDynamic`` [C, 1])

PyTorch runs eagerly and would not need fixed shapes to avoid recompiles,
but the contract stays: every index the kernels return, every mask and
every parity test against the JAX package depends on slots that do not
move.  Deletions only clear mask bits; compaction happens at explicit
boundaries (``compact``, ``insert``, ``concatenate``).  Nothing in this
module reads a tensor back to the host, so none of it synchronises a CUDA
stream.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from .draws import resolve_device
from .utils import tracing

__all__ = ["PointBatch", "bucket_capacity", "concatenate", "insert",
           "padded_numpy"]

_MIN_CAPACITY = 256


def bucket_capacity(n: int) -> int:
    """Round ``n`` up to a capacity bucket (quarter-power-of-two steps,
    min 256: 256, 320, 384, 448, 512, 640, ...).

    Buckets keep reallocation rare while capping the padding at 25 % (every
    capacity-proportional pass -- sorts, scatters, elementwise filters --
    pays for padding)."""
    if n <= _MIN_CAPACITY:
        return _MIN_CAPACITY
    p = 1 << (int(n).bit_length() - 1)  # largest power of two <= n
    step = p // 4
    return -(-n // step) * step


def padded_numpy(positions, descriptors=None,
                 capacity: Optional[int] = None):
    """The host arrays of a PointBatch of ``n`` real points: ``(positions
    f32[cap, dim], mask bool[cap], {name: f32[cap, k]})``, zero-padded to
    ``capacity`` (default ``bucket_capacity(n)``)."""
    positions = np.asarray(positions, dtype=np.float32)
    n, dim = positions.shape
    cap = capacity if capacity is not None else bucket_capacity(n)
    if cap < n:
        raise ValueError(f"capacity {cap} < point count {n}")
    pos = np.zeros((cap, dim), dtype=np.float32)
    pos[:n] = positions
    mask = np.zeros((cap,), dtype=bool)
    mask[:n] = True
    desc = {}
    for name, v in (descriptors or {}).items():
        v = np.asarray(v, dtype=np.float32)
        if v.ndim == 1:
            v = v[:, None]
        d = np.zeros((cap, v.shape[1]), dtype=np.float32)
        d[:n] = v
        desc[name] = d
    return pos, mask, desc


def _scatter_rows(dst: torch.Tensor, tgt: torch.Tensor,
                  src: torch.Tensor) -> torch.Tensor:
    """``dst`` with ``dst[tgt[i]] = src[i]``; rows whose target equals
    ``dst.shape[0]`` are dropped (they land in a scratch row)."""
    cap = dst.shape[0]
    buf = torch.cat([dst, dst.new_zeros((1,) + tuple(dst.shape[1:]))])
    buf.index_copy_(0, tgt, src)
    return buf[:cap]


@dataclasses.dataclass(frozen=True)
class PointBatch:
    """Fixed-capacity masked point cloud."""

    positions: torch.Tensor  # f32[C, dim]
    mask: torch.Tensor  # bool[C]
    descriptors: Dict[str, torch.Tensor] = dataclasses.field(
        default_factory=dict)

    # ---------------------------------------------------------------- meta
    @property
    def capacity(self) -> int:
        return self.positions.shape[0]

    @property
    def dim(self) -> int:
        return self.positions.shape[1]

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def count(self) -> torch.Tensor:
        """Number of valid points (0-d int64 tensor on the batch's device)."""
        return self.mask.sum()

    def has_descriptor(self, name: str) -> bool:
        return name in self.descriptors

    # -------------------------------------------------------- constructors
    @staticmethod
    def from_numpy(
        positions: np.ndarray,
        descriptors: Optional[Dict[str, np.ndarray]] = None,
        capacity: Optional[int] = None,
        device: Union[str, torch.device, None] = "cuda",
    ) -> "PointBatch":
        """Build a padded PointBatch from host arrays of n real points."""
        dev = resolve_device(device)
        pos, mask, desc = padded_numpy(positions, descriptors, capacity)
        return PointBatch(torch.from_numpy(pos).to(dev),
                          torch.from_numpy(mask).to(dev),
                          {k: torch.from_numpy(v).to(dev)
                           for k, v in desc.items()})

    @staticmethod
    def empty(capacity: int, dim: int = 3,
              descriptor_dims: Optional[Dict[str, int]] = None,
              device: Union[str, torch.device, None] = "cuda"
              ) -> "PointBatch":
        dev = resolve_device(device)
        desc = {
            name: torch.zeros((capacity, k), dtype=torch.float32, device=dev)
            for name, k in (descriptor_dims or {}).items()
        }
        return PointBatch(
            torch.zeros((capacity, dim), dtype=torch.float32, device=dev),
            torch.zeros((capacity,), dtype=torch.bool, device=dev),
            desc,
        )

    # -------------------------------------------------------------- export
    def to_numpy(self) -> Dict[str, np.ndarray]:
        """Compact to host arrays holding only the valid points, in order.

        Returns a dict with 'positions' and one entry per descriptor."""
        mask = self.mask.cpu().numpy()
        out = {"positions": self.positions.cpu().numpy()[mask]}
        for name, v in self.descriptors.items():
            out[name] = v.cpu().numpy()[mask]
        return out

    def to(self, device: Union[str, torch.device]) -> "PointBatch":
        dev = torch.device(device)
        return PointBatch(self.positions.to(dev), self.mask.to(dev),
                          {k: v.to(dev) for k, v in self.descriptors.items()})

    # ------------------------------------------------------- functional ops
    def with_mask(self, new_mask: torch.Tensor) -> "PointBatch":
        return dataclasses.replace(self, mask=new_mask & self.mask)

    def replace(self, **kw) -> "PointBatch":
        return dataclasses.replace(self, **kw)

    def with_descriptor(self, name: str, value: torch.Tensor) -> "PointBatch":
        if value.ndim == 1:
            value = value[:, None]
        desc = dict(self.descriptors)
        desc[name] = value
        return dataclasses.replace(self, descriptors=desc)

    def compact(self) -> "PointBatch":
        """Move valid points to the front (stable), keeping capacity.

        Cumsum + scatter (O(C), no sort); invalid slots are zero-filled."""
        cap = self.capacity
        dest = torch.cumsum(self.mask.to(torch.int64), 0) - 1
        tgt = torch.where(self.mask, dest, torch.full_like(dest, cap))
        pos = _scatter_rows(torch.zeros_like(self.positions), tgt,
                            self.positions)
        mask = _scatter_rows(torch.zeros_like(self.mask), tgt, self.mask)
        desc = {k: _scatter_rows(torch.zeros_like(v), tgt, v)
                for k, v in self.descriptors.items()}
        return PointBatch(pos, mask, desc)

    def gather(self, idx: torch.Tensor) -> "PointBatch":
        """Reindex all channels by ``idx`` (mask gathered too)."""
        desc = {k: v[idx] for k, v in self.descriptors.items()}
        return PointBatch(self.positions[idx], self.mask[idx], desc)

    def pad_to(self, capacity: int) -> "PointBatch":
        """Grow capacity (no-op if already >=). Padded tail is masked out."""
        if capacity <= self.capacity:
            return self
        extra = capacity - self.capacity

        def grow(v):
            return torch.cat(
                [v, v.new_zeros((extra,) + tuple(v.shape[1:]))])

        return PointBatch(grow(self.positions), grow(self.mask),
                          {k: grow(v) for k, v in self.descriptors.items()})

    def align_descriptors(self, names, dims) -> "PointBatch":
        """Ensure descriptors ``names`` exist (zero-filled if missing)."""
        desc = dict(self.descriptors)
        for name, k in zip(names, dims):
            if name not in desc:
                desc[name] = torch.zeros((self.capacity, k),
                                         dtype=torch.float32,
                                         device=self.device)
        return dataclasses.replace(self, descriptors=desc)


def _union_descriptors(a: PointBatch, b: PointBatch):
    names = sorted(set(a.descriptors) | set(b.descriptors))
    dims = [(a.descriptors[n] if n in a.descriptors
             else b.descriptors[n]).shape[1] for n in names]
    return (names, a.align_descriptors(names, dims),
            b.align_descriptors(names, dims))


def insert(dst: PointBatch, src: PointBatch, return_dropped: bool = False):
    """Write ``src``'s valid points into ``dst``'s free slots, in order.

    ``dst`` is compacted (valid points to the front, order preserved), then
    ``src``'s valid points go into slots ``[count, count + n_src)``.  The
    result has ``dst``'s capacity; the caller sizes ``dst`` with enough
    headroom, and points past capacity are dropped.  With
    ``return_dropped=True`` the number of dropped points comes back as a
    second value (0-d int64 tensor), so no cap is silent; with an overflow
    sink installed it is also recorded as ``points_insert``
    (``utils/tracing.py``).

    Descriptor sets are unioned; channels missing on either side zero-fill.
    """
    cap = dst.capacity
    names, dst, src = _union_descriptors(dst, src)

    dst = dst.compact()
    n = dst.mask.sum()
    n_src = src.mask.sum()
    slot = n + torch.cumsum(src.mask.to(torch.int64), 0) - 1
    tgt = torch.where(src.mask & (slot < cap), slot,
                      torch.full_like(slot, cap))  # cap -> dropped

    pos = _scatter_rows(dst.positions, tgt, src.positions)
    mask = _scatter_rows(dst.mask, tgt, src.mask)
    desc = {k: _scatter_rows(dst.descriptors[k], tgt, src.descriptors[k])
            for k in names}
    out = PointBatch(pos, mask, desc)
    if return_dropped or tracing.recording_overflow():
        dropped = torch.clamp(n + n_src - cap, min=0)
        tracing.record_overflow("points_insert", dropped)
        if return_dropped:
            return out, dropped
    return out


def concatenate(a: PointBatch, b: PointBatch,
                capacity: Optional[int] = None) -> PointBatch:
    """Concatenate two batches into a batch of given capacity.

    Valid points of ``a`` come first, then valid points of ``b``.
    Descriptor sets are unioned; missing channels zero-fill.  The result is
    compacted."""
    cap = capacity if capacity is not None else a.capacity + b.capacity
    names, a, b = _union_descriptors(a, b)
    pos = torch.cat([a.positions, b.positions])
    mask = torch.cat([a.mask, b.mask])
    desc = {n: torch.cat([a.descriptors[n], b.descriptors[n]]) for n in names}
    merged = PointBatch(pos, mask, desc).compact()
    if cap >= merged.capacity:
        return merged.pad_to(cap)
    # shrink: keep first `cap` slots (caller guarantees they hold all valid pts)
    return PointBatch(merged.positions[:cap], merged.mask[:cap],
                      {k: v[:cap] for k, v in merged.descriptors.items()})
