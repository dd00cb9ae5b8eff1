"""The per-scan step of the offline mapping path, as one eager function.

The reference's per-scan work is a chain of calls -- transform, ICP,
update-condition policy, module merge, post filters, rebuild of the
matcher's reference:

  transform -> ICP solve -> update condition -> if merge:
  modules -> sensor-frame post filters -> ICP reference filters ->
  sorted reference pack

``FusedScanStep`` keeps that chain in one place with the map as explicit
state, so the Mapper's hot path is a single call per scan:

  bufs:  map       PointBatch -- local point cloud, fixed capacity w/ headroom
         ref       PointBatch -- reference-filtered map for ICP (only when
                                 the engine has referenceDataPointsFilters)
         ref_pack  pack       -- what the matcher prepares once per reference
                                 (the sweep's sorted pack, or the packed
                                 valid references of the brute-force
                                 search), carried across scans, rebuilt
                                 only on merge
  meta:  pose      (D+1,D+1)  -- corrected pose of the latest scan   (host)
         last_pose (D+1,D+1)  -- pose at the last map update         (host)
         last_t    f32        -- seconds at the last map update      (host)

The clouds live on the mapper's device; poses and the update condition live
on the host.  The merge decision is a host branch: the solve already brings
its 4x4 correction to the host (see ``icp/engine.py``), so the ``distance``
and ``delay`` conditions cost no extra read, and the ``overlap`` condition
reads one scalar.  The online register/merge split of the reference is not
ported yet.

``PhaseTimer`` measures where a scan's time goes (CUDA events on the card).
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, List

import numpy as np
import torch

from . import se3
from .points import PointBatch
from .map import apply_post_filters

__all__ = ["FusedScanStep", "PhaseTimer"]


class PhaseTimer:
    """Per-phase device time of the per-scan step.  Off by default; when
    ``enabled`` each phase is bracketed by CUDA events on the current stream
    (host clock on the CPU) and ``totals()`` returns milliseconds by name.
    Phases nest: an outer phase includes its inner ones."""

    def __init__(self):
        self.enabled = False
        self._events: List = []  # (name, start, end) or (name, ms)

    @contextlib.contextmanager
    def phase(self, name: str, device: torch.device):
        if not self.enabled:
            yield
            return
        if device.type == "cuda":
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
        if reset:
            self._events = []
        return out


class FusedScanStep:
    """The per-scan step of a configured Mapper.

    The scan passed to ``__call__`` must already be input-filtered (the
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
        bufs = {"map": local}
        if self.has_ref:
            bufs["ref"] = ref if ref is not None else local
        sref = bufs.get("ref", bufs["map"])
        pack = self._m.icp._ref_pack
        if pack is None or self._m.icp._ref is not sref:
            pack = self._m.icp.build_ref_pack(sref)
        bufs["ref_pack"] = pack
        meta = {
            "pose": torch.as_tensor(np.asarray(pose), dtype=torch.float32),
            "last_pose": torch.as_tensor(np.asarray(last_pose),
                                         dtype=torch.float32),
            "last_t": np.float32(last_t_s),
        }
        return bufs, meta

    def __call__(self, bufs, meta, scan: PointBatch, est_pose, stamp_s,
                 is_mapping: bool):
        return self._step_impl(bufs, meta, scan, est_pose, stamp_s,
                               is_mapping)

    # ------------------------------------------------------------------
    def _solve_and_condition(self, bufs, meta, scan_m, est_pose, stamp_s,
                             is_mapping):
        """ICP -> shouldUpdateMap (reference ``Mapper.cpp:240-272``)."""
        m = self._m
        d = m.dim
        ref = bufs["ref"] if self.has_ref else bufs["map"]
        reading = scan_m
        if len(m.icp.reading_filters):
            reading = m.icp.reading_filters._apply_impl(reading, m.draws)
        ref_normals = m.icp.check_reference(ref)
        correction, overlap, iters, _resid = m.icp.solve(
            reading.positions, reading.mask, ref.positions, ref_normals,
            ref.mask, bufs["ref_pack"], draws=m.draws)
        corrected = correction @ est_pose

        cond = m.map_update_condition
        if cond == "overlap":
            should = float(overlap) < m.map_update_overlap  # one scalar read
        elif cond == "delay":
            should = bool(np.float32(stamp_s - meta["last_t"])
                          > np.float32(m.map_update_delay))
        else:  # distance
            should = float(torch.linalg.norm(
                corrected[:d, d] - meta["last_pose"][:d, d])) \
                > m.map_update_distance
        do_merge = should and bool(is_mapping)
        return correction, corrected, overlap, iters, do_merge

    def _merge_bufs(self, bufs, scan_m, correction, corrected):
        """The merge (reference ``Map.cpp:502-534``), at fixed capacity."""
        m = self._m
        dev = scan_m.device
        scan_c = se3.apply(correction, scan_m)
        local = bufs["map"]
        for mod in m.map.modules:
            with m.timer.phase(mod.NAME, dev):
                local = mod.update_map(scan_c, local, corrected, m.draws)
        local = apply_post_filters(local, corrected, m.post_filters, m.draws,
                                   timer=m.timer)
        new = {"map": local}
        if self.has_ref:
            with m.timer.phase("reference_filters", dev):
                new["ref"] = m.icp.reference_filters._apply_impl(local,
                                                                 m.draws)
        # the solve reference changed -- rebuild the matcher's pack (once
        # per merge instead of once per solve)
        sref = new.get("ref", new["map"])
        with m.timer.phase("ref_pack", dev):
            new["ref_pack"] = m.icp.build_ref_pack(sref)
        return new

    def _step_impl(self, bufs, meta, scan, est_pose, stamp_s, is_mapping):
        m = self._m
        dev = scan.device
        est_pose = torch.as_tensor(np.asarray(est_pose), dtype=torch.float32)
        # scan -> map frame with the pose prior (reference Mapper.cpp:197)
        scan_m = se3.apply(est_pose, scan)
        with m.timer.phase("solve", dev):
            correction, corrected, overlap, iters, do_merge = \
                self._solve_and_condition(bufs, meta, scan_m, est_pose,
                                          stamp_s, is_mapping)
        if do_merge:
            with m.timer.phase("merge", dev):
                new_bufs = self._merge_bufs(bufs, scan_m, correction,
                                            corrected)
        else:
            new_bufs = dict(bufs)
        new_meta = {
            "pose": corrected,
            "last_pose": corrected if do_merge else meta["last_pose"],
            "last_t": np.float32(stamp_s) if do_merge else meta["last_t"],
        }
        aux = {
            "merged": do_merge,
            "overlap": overlap,
            "iterations": iters,
        }
        return new_bufs, new_meta, aux
