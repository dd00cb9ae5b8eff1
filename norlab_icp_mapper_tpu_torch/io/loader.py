"""Prefetching scan loader: files parsed on threads, scans on the card ahead
of the pipeline.

Scans parse on background threads (the native VTK parser when available;
it releases the interpreter lock) while the card runs earlier scans, as the
reference drives its IO from a separate thread (``Map.cpp:29-57``).  On a
CUDA device each scan is also uploaded on the loader's own **side stream**:
the padded arrays are copied into pinned host memory, sent with
``copy_(non_blocking=True)`` and an event is recorded behind the copies.
At hand-over the consumer's current stream waits on that event
(``wait_event``, on the card: the host does not wait), and every tensor of
the batch is marked with ``record_stream`` for the consumer's stream, so
the caching allocator does not hand its memory on while the pipeline still
reads it.  The pinned buffers are kept until their event has passed.

``draws.upload`` copies on the *current* stream; from a worker thread that
is the default stream, behind the mapper's queued work: correct, but the
copy would wait for the step before it.  The side stream lets the upload
run beside the step.
"""
from __future__ import annotations

import collections
import concurrent.futures
from typing import Iterator, List, Optional, Sequence, Tuple, Union

import torch

from . import read_point_cloud
from ..draws import resolve_device
from ..points import PointBatch, padded_numpy

__all__ = ["ScanLoader"]


class ScanLoader:
    """Iterate ``(PointBatch, n_valid, extra)`` over scan files, in order,
    with ``prefetch`` scans parsed (and uploaded) ahead.

    ``device`` defaults to the card and raises without one; pass
    ``device="cpu"`` for batches on the CPU."""

    def __init__(self, paths: Sequence[str],
                 extras: Optional[Sequence] = None,
                 prefetch: int = 2, capacity: Optional[int] = None,
                 workers: int = 2,
                 device: Union[str, torch.device, None] = None):
        self.paths = list(paths)
        self.extras = (list(extras) if extras is not None
                       else [None] * len(self.paths))
        if len(self.extras) != len(self.paths):
            raise ValueError(f"{len(self.extras)} extras for "
                             f"{len(self.paths)} paths")
        self.prefetch = max(1, prefetch)
        self.capacity = capacity
        self.device = resolve_device(device)
        self._stream = None
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            self._stream = torch.cuda.Stream(self.device)
        # (event, pinned buffers) of uploads the card may still be reading
        self._in_flight: "collections.deque" = collections.deque()
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)

    def _load(self, path: str):
        """Parse one file (worker thread); on the card, upload it on the
        side stream.  Returns ``(batch, n_valid, event, pinned)``."""
        pos, desc = read_point_cloud(path)
        p, m, d = padded_numpy(pos, desc, self.capacity)
        names = list(d)
        host = [torch.from_numpy(a) for a in [p, m] + [d[k] for k in names]]
        if self._stream is None:
            batch = PointBatch(host[0], host[1], dict(zip(names, host[2:])))
            return batch, pos.shape[0], None, None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            pinned = [h.pin_memory() for h in host]
            dev = [torch.empty(h.shape, dtype=h.dtype, device=self.device)
                   for h in pinned]
            for d_t, h in zip(dev, pinned):
                d_t.copy_(h, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        batch = PointBatch(dev[0], dev[1], dict(zip(names, dev[2:])))
        return batch, pos.shape[0], event, pinned

    def _hand_over(self, batch: PointBatch, event, pinned) -> PointBatch:
        """Order the consumer's stream after the upload (on the card) and
        tie the batch's memory to that stream."""
        if event is None:
            return batch
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(event)
        for t in (batch.positions, batch.mask, *batch.descriptors.values()):
            t.record_stream(stream)
        self._in_flight.append((event, pinned))
        while self._in_flight and self._in_flight[0][0].query():
            self._in_flight.popleft()
        return batch

    def __len__(self) -> int:
        return len(self.paths)

    def __iter__(self) -> Iterator[Tuple[PointBatch, int, object]]:
        """Yields ``(batch, n_valid, extra)``: ``n_valid`` is the real
        (pre-padding) point count, the map-headroom hint for
        ``Mapper.process_input(scan_valid_hint=...)``."""
        futures: List[concurrent.futures.Future] = []
        n = len(self.paths)
        idx = 0
        for _ in range(min(self.prefetch, n)):
            futures.append(self._pool.submit(self._load, self.paths[idx]))
            idx += 1
        for i in range(n):
            batch, n_valid, event, pinned = futures.pop(0).result()
            if idx < n:
                futures.append(self._pool.submit(self._load, self.paths[idx]))
                idx += 1
            yield self._hand_over(batch, event, pinned), n_valid, \
                self.extras[i]

    def close(self):
        self._pool.shutdown(wait=False)
