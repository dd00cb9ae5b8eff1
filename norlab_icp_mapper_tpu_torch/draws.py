"""Devices and explicit randomness for the port.

Two things every entry point of the port takes explicitly:

* a ``device``.  It defaults to ``"cuda"``; asking for the card on a machine
  that has none raises instead of carrying on on the CPU.
* the random draws.  The JAX package draws from threefry keys; torch's
  generator cannot reproduce those numbers, so every drawing site accepts
  the draws themselves.  A :class:`DrawSource` hands them out, either from a
  seeded ``torch.Generator`` or from a caller-supplied callable
  ``(site: str, n: int) -> Tensor`` (the parity tests use the latter to feed
  both packages the same numbers).

Drawing sites on the ported path:

* ``SITE_RANDOM_SAMPLING`` -- ``RandomSamplingDataPointsFilter``: ``n``
  uniforms in ``[0, 1)``, float32.
* ``SITE_OCTREE_PRIO`` -- the voxel decimation's random tie-break priorities
  (``samplingMethod: 1``): ``n`` integers in ``[0, 2**15)``.
* ``SITE_OCTREE_LEAF`` -- the octree decimation with ``maxPointByNode > 1``
  and ``samplingMethod: 1``: one key per point, ``n`` integers in
  ``[0, 2**30)``; the smallest key of a leaf picks its representative.

Inside an ICP solve the reading step filters draw from a keyed view of the
source instead (:meth:`DrawSource.keyed`, :class:`KeyedDraws`): Philox
uniforms (``ops/philox.py``) keyed by the source's seed and counted by the
solve's index, the loop's device ``it`` and the reading's original row --
the counterpart of the JAX package's ``fold_in(key, it)``.  They need no
host, so a CUDA graph of the solve draws anew at every pass, and the card
and the CPU draw the same numbers.  A caller-supplied ``source`` is asked
once per matcher pass instead, under the CPU's Python loop only.

A RandomSampling filter asks for its keep mask, not for the uniforms
(:meth:`DrawSource.keep`, :meth:`KeyedDraws.keep`): ``mask & (u < prob)``,
where row ``j`` takes the draw of original row ``rows[j]``.  The solve runs
its step chain on the reading in its own (sorted) row order and passes the
sort as ``rows``, so every draw lands on the point it lands on unsorted;
keyed, that is one ``philox_keep`` launch per pass.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import torch

__all__ = ["DrawSource", "KeyedDraws", "resolve_device", "upload",
           "SITE_RANDOM_SAMPLING", "SITE_OCTREE_PRIO", "SITE_OCTREE_LEAF"]

SITE_RANDOM_SAMPLING = "random_sampling"
SITE_OCTREE_PRIO = "octree_prio15"
SITE_OCTREE_LEAF = "octree_leaf30"


def resolve_device(device: Union[str, torch.device, None] = "cuda"
                   ) -> torch.device:
    """Return ``torch.device(device)``; raise if it names a CUDA device and
    this machine has none.  ``None`` means the default, ``"cuda"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested (the default) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU")
    return dev


def upload(x, device: torch.device,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``x`` (an array, a tensor or anything ``torch.as_tensor`` takes) as a
    new tensor on ``device``.  A host value goes to a card through pinned
    memory and a non-blocking copy: a copy from pageable memory would make
    the host wait for the card's stream."""
    t = torch.as_tensor(x, dtype=dtype)
    if device.type == "cuda" and not t.is_cuda:
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device, copy=True)


class DrawSource:
    """Hands out the random draws of one Mapper / filter chain.

    ``source`` (optional) replaces the generator: it is called as
    ``source(site, n)`` and must return a tensor (or array) of ``n`` draws
    of the site's kind.
    """

    def __init__(self, seed: int = 0,
                 device: Union[str, torch.device] = "cpu",
                 source: Optional[Callable[[str, int], torch.Tensor]] = None):
        self.device = torch.device(device)
        self.source = source
        self.seed = int(seed)
        self.solves = 0  # solves keyed so far (see next_solve)
        # the generator lives on the CPU so that a seed gives the same
        # draws on every device; draws are a few hundred KB per scan
        self.generator = torch.Generator(device="cpu")
        self.generator.manual_seed(int(seed))

    def _from_source(self, site: str, n: int, dtype) -> torch.Tensor:
        out = torch.as_tensor(self.source(site, n))
        if out.shape != (n,):
            raise ValueError(
                f"draw_source('{site}', {n}) returned shape "
                f"{tuple(out.shape)}, expected ({n},)")
        return upload(out, self.device, dtype)

    def uniform(self, site: str, n: int) -> torch.Tensor:
        """``n`` float32 uniforms in ``[0, 1)`` on the source's device."""
        if self.source is not None:
            return self._from_source(site, n, torch.float32)
        return upload(torch.rand(n, generator=self.generator,
                                 dtype=torch.float32), self.device)

    def keep(self, site: str, prob: float, mask: torch.Tensor,
             rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask & (u[rows] < prob)`` on the device of ``mask``: ``u`` one
        uniform per row of ``mask`` (:meth:`uniform`), ``rows`` the original
        row of each row (None: the rows as they are), ``prob`` compared in
        float32."""
        u = self.uniform(site, mask.shape[0]).to(mask.device)
        if rows is not None:
            u = u[rows]
        return mask & (u < torch.full((), prob, dtype=torch.float32,
                                      device=mask.device))

    def prio15(self, site: str, n: int) -> torch.Tensor:
        """``n`` int64 priorities in ``[0, 2**15)`` on the source's device."""
        if self.source is not None:
            return self._from_source(site, n, torch.int64)
        return upload(torch.randint(0, 1 << 15, (n,), generator=self.generator,
                                    dtype=torch.int64), self.device,
                      torch.int64)

    def int30(self, site: str, n: int) -> torch.Tensor:
        """``n`` int64 keys in ``[0, 2**30)`` on the source's device."""
        if self.source is not None:
            return self._from_source(site, n, torch.int64)
        return upload(torch.randint(0, 1 << 30, (n,), generator=self.generator,
                                    dtype=torch.int64), self.device,
                      torch.int64)

    def next_solve(self) -> int:
        """The index of the next solve whose step filters draw keyed
        (:meth:`keyed`); one more on every call, a host counter, alike on
        every rank of a sharded map."""
        i = self.solves
        self.solves += 1
        return i

    def keyed(self, solve: torch.Tensor, it: torch.Tensor) -> "KeyedDraws":
        """The draws of one matcher pass of solve ``solve`` (0-d int64) at
        the loop's iteration ``it`` (0-d int32), both on the device the
        draws are made on."""
        return KeyedDraws(self.seed, solve, it)


class KeyedDraws:
    """One matcher pass's draws inside a solve: a function of the seed, the
    solve index and ``it`` (read on their device, never on the host), the
    row, and the draw's place among the pass's draws.  ``uniform``, ``keep``
    (the same words, compared in ``philox_keep``) and ``prio15`` (``(word >>
    17)`` of the same Philox words: ``floor(u * 2**15)``) cover the step
    chain's drawing filters."""

    source = None

    def __init__(self, seed: int, solve: torch.Tensor, it: torch.Tensor):
        self.seed, self.solve, self.it = int(seed), solve, it
        self.device = it.device
        self.calls = 0

    def uniform(self, site: str, n: int) -> torch.Tensor:
        from .ops.philox import philox_uniform
        u = philox_uniform(self.seed, self.solve, self.it, self.calls, n)
        self.calls += 1
        return u

    def keep(self, site: str, prob: float, mask: torch.Tensor,
             rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        from .ops.philox import philox_keep
        k = philox_keep(self.seed, self.solve, self.it, self.calls, prob,
                        mask, rows)
        self.calls += 1
        return k

    def prio15(self, site: str, n: int) -> torch.Tensor:
        return (self.uniform(site, n) * float(1 << 15)).to(torch.int64)
