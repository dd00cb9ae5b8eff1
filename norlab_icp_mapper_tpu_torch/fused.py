"""The per-scan step of the fused mapping path, in two parts.

The reference's per-scan work is a chain of calls -- transform, ICP,
update-condition policy, module merge, post filters, rebuild of the
matcher's reference:

  register: transform -> ICP solve -> update condition
  merge:    (if the condition holds) modules -> sensor-frame post filters
            -> ICP reference filters -> matcher's pack

``FusedScanStep`` keeps that chain in one place with the map as explicit
state.  Every output stays on the mapper's device and nothing is read on
the host, except the one boolean below:

  bufs:  map       PointBatch -- local point cloud, fixed capacity w/ headroom
         ref       PointBatch -- reference-filtered map for ICP (only when
                                 the engine has referenceDataPointsFilters)
         ref_pack  pack       -- what the matcher prepares once per reference
                                 (the sweep's sorted pack, or the packed
                                 valid references of the brute-force
                                 search), carried across scans, rebuilt
                                 only on merge
  meta:  pose      (D+1,D+1)  -- corrected pose of the latest scan (device)
         last_pose (D+1,D+1)  -- pose at the last map update      (device)
         last_t    f32        -- seconds at the last map update   (host)

The merge decision is the JAX package's ``lax.cond`` as a host branch.
Under the ``delay`` condition (both bundled configs) it is a comparison of
host stamps and reads nothing.  Under ``distance`` or ``overlap`` the host
reads the one ``merged`` boolean after the solve: it waits for the solve
only, and it is the only read of such a scan.

The Mapper enqueues ``register`` and ``merge`` back to back on one stream
and files the pose's host copy between them (see ``mapper.py``), so that a
consumer of the pose waits for the solve and not for the merge -- what the
JAX package gets from its two programs in online mode.

``PhaseTimer`` is the port's tracer: off by default; when enabled,
``totals()`` holds four kinds of name --

  <name>         device work (CUDA events on the card): ``solve`` and its
                 ``icp_solve``, ``merge`` and the modules, filters,
                 ``reference_filters`` and ``ref_pack`` inside it
  host.<name>    the host's own clock around a call: ``process_input``,
                 ``input_filters``
  wait.<cause>   one blocking read of the card, a cause of ``Mapper.waits``
  count.<name>   a counter: ``icp_iterations``, and for the grid matcher
                 ``nn_grid_queries`` and ``nn_grid_fallbacks``, read at
                 harvest

and each span is also a ``mapper.<name>`` profiler range, on the device
trace's clock.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from . import se3
from .draws import upload
from .points import PointBatch
from .map import apply_post_filters
from .utils.tracing import trace

__all__ = ["FusedScanStep", "PhaseTimer"]

_OFF = contextlib.nullcontext()  # every span of a disabled timer


class PhaseTimer:
    """The port's spans and counters.  Off by default: a span is then a
    shared null context and a counter returns at once, with no clock read,
    event, range or dict touched.  When ``enabled``:

    * ``phase(name, device)``: device time of the block, as CUDA events on
      the current stream (the host clock on the CPU), under ``name``;
    * ``host(name)``: the host clock around the block, under ``host.name``;
    * ``wait(cause)``: the host clock around one blocking read, under
      ``wait.cause``;
    * ``count(name, n)``: adds ``n`` under ``count.name``.

    Every span also opens the profiler range ``mapper.<its name>``
    (``utils.tracing.trace``), so a device trace puts each kernel and each
    idle gap under a span.  ``totals()`` returns one flat dict: milliseconds
    by span name, summed (spans nest: an outer span includes its inner
    ones), and the counters under ``count.``."""

    def __init__(self):
        self.enabled = False
        self._events: List = []  # (name, start, end) or (name, ms)
        self._counts: Dict[str, int] = {}

    def phase(self, name: str, device: torch.device):
        if not self.enabled:
            return _OFF
        return self._span(name, device.type == "cuda")

    def host(self, name: str):
        if not self.enabled:
            return _OFF
        return self._span("host." + name, False)

    def wait(self, cause: str):
        if not self.enabled:
            return _OFF
        return self._span("wait." + cause, False)

    def count(self, name: str, n: int = 1) -> None:
        if not self.enabled:
            return
        key = "count." + name
        self._counts[key] = self._counts.get(key, 0) + n

    @contextlib.contextmanager
    def _span(self, name: str, on_card: bool):
        with trace("mapper." + name):
            if on_card:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                yield
                end.record()
                self._events.append((name, start, end))
            else:
                t0 = time.perf_counter()
                yield
                self._events.append((name, (time.perf_counter() - t0) * 1e3))

    def totals(self, reset: bool = True) -> Dict[str, float]:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        out: Dict[str, float] = {}
        for ev in self._events:
            ms = ev[1] if len(ev) == 2 else ev[1].elapsed_time(ev[2])
            out[ev[0]] = out.get(ev[0], 0.0) + ms
        out.update(self._counts)
        if reset:
            self._events = []
            self._counts = {}
        return out


class FusedScanStep:
    """The per-scan step of a configured Mapper.

    The scan passed to ``register`` must already be input-filtered (the
    public ``apply_input_filters`` contract matches the reference, where the
    caller sees the filtered cloud) and in the *sensor* frame.
    """

    def __init__(self, mapper):
        self._m = mapper

    @property
    def has_ref(self) -> bool:
        return len(self._m.icp.reference_filters) > 0

    def init_state(self, local: PointBatch, ref, pose, last_pose,
                   last_t_s: float):
        """Returns (bufs, meta)."""
        dev = local.device
        bufs = {"map": local}
        if self.has_ref:
            bufs["ref"] = ref if ref is not None else local
        sref = bufs.get("ref", bufs["map"])
        pack = self._m.icp._ref_pack
        if pack is None or self._m.icp._ref is not sref:
            pack = self._m.icp.build_ref_pack(sref)
        bufs["ref_pack"] = pack
        meta = {
            "pose": upload(pose, dev),
            "last_pose": upload(last_pose, dev),
            "last_t": np.float32(last_t_s),
        }
        return bufs, meta

    # ------------------------------------------------------------------
    def register(self, bufs, meta, scan: PointBatch, est_pose, stamp_s,
                 is_mapping: bool):
        """Transform -> ICP -> shouldUpdateMap (reference
        ``Mapper.cpp:194-272``).  Returns ``(new_meta, aux)``: ``aux`` holds
        ``correction``, ``overlap`` and ``iterations`` (device tensors), the
        grid matcher's counts ``nn_grid`` (``ICPEngine.last_nn_grid``), the
        host boolean ``merged``, the scan in the map frame and the solve's
        graph replay (``ICPEngine.last_replay``)."""
        m = self._m
        d = m.dim
        dev = scan.device
        est = upload(est_pose, dev)
        # scan -> map frame with the pose prior (reference Mapper.cpp:197)
        scan_m = se3.apply(est, scan)
        with m.timer.phase("solve", dev):
            ref = bufs["ref"] if self.has_ref else bufs["map"]
            reading = scan_m
            if len(m.icp.reading_filters):
                reading = m.icp.reading_filters._apply_impl(reading, m.draws)
            ref_normals = m.icp.check_reference(ref)
            with m.timer.phase("icp_solve", dev):
                correction, overlap, iters, _resid = m.icp.solve(
                    reading.positions, reading.mask, ref.positions,
                    ref_normals, ref.mask, bufs["ref_pack"], draws=m.draws)
            corrected = correction @ est
            cond = m.map_update_condition
            if not is_mapping:
                should = False
            elif cond == "delay":
                should = bool(np.float32(stamp_s - meta["last_t"])
                              > np.float32(m.map_update_delay))
            else:
                if cond == "overlap":
                    gate = overlap < m.map_update_overlap
                else:  # distance
                    gate = torch.linalg.norm(
                        corrected[:d, d] - meta["last_pose"][:d, d]) \
                        > m.map_update_distance
                with m._waiting("merge_decision"):
                    should = bool(gate)  # the read
        new_meta = {
            "pose": corrected,
            "last_pose": corrected if should else meta["last_pose"],
            "last_t": np.float32(stamp_s) if should else meta["last_t"],
        }
        aux = {"correction": correction, "merged": should,
               "overlap": overlap, "iterations": iters,
               "nn_grid": m.icp.last_nn_grid, "scan_m": scan_m,
               "corrected": corrected, "replay": m.icp.last_replay}
        return new_meta, aux

    def merge(self, bufs, aux):
        """The merge (reference ``Map.cpp:502-534``) at fixed capacity when
        ``aux["merged"]``; returns ``(new_bufs, count)``, the map's count of
        valid points as a 0-d device tensor."""
        new = (self._merge_bufs(bufs, aux["scan_m"], aux["correction"],
                                aux["corrected"])
               if aux["merged"] else dict(bufs))
        return new, new["map"].count()

    def _merge_bufs(self, bufs, scan_m, correction, corrected):
        m = self._m
        dev = scan_m.device
        with m.timer.phase("merge", dev):
            scan_c = se3.apply(correction, scan_m)
            local = bufs["map"]
            for mod in m.map.modules:
                with m.timer.phase(mod.NAME, dev):
                    local = mod.update_map(scan_c, local, corrected, m.draws)
            local = apply_post_filters(local, corrected, m.post_filters,
                                       m.draws, timer=m.timer)
            new = {"map": local}
            if self.has_ref:
                with m.timer.phase("reference_filters", dev):
                    new["ref"] = m.icp.reference_filters._apply_impl(
                        local, m.draws)
            # the solve reference changed -- rebuild the matcher's pack
            # (once per merge instead of once per solve)
            sref = new.get("ref", new["map"])
            with m.timer.phase("ref_pack", dev):
                new["ref_pack"] = m.icp.build_ref_pack(sref)
        return new
