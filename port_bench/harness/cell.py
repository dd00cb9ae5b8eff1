"""One run of one cell: set-up, the measured window, the per-layer
metrics of a traced run, and the judgement of what the window produced.

The traffic mix's parameters (``traffic/<name>.json``) choose the loop:

* ``"loop": "closed"``: the patrol's scans, already on the card, go to
  ``process_input`` back to back on the pipelined loop; ``drain()`` ends
  the window.  ``scans_per_s`` is the scans completed over the window's
  whole time.
* ``"loop": "open"``: scan ``j`` is due ``j / rate_hz`` after the window
  opens and is handed over, in pinned host memory, no earlier; every scan
  is followed by ``get_pose()``.  A scan's latency runs from its due time
  to its pose on the host, so a stall delays the scans behind it too.

Both loops feed scans of laps after the first; the first lap, at the
mix's ``warmup_stride``, builds the map in set-up and captures the solve
graph, as a robot that has mapped its hall once.
"""
from __future__ import annotations

import gc
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import trace
from .scene import Scene


def nearest_rank(values: List[float], q: float) -> float:
    """The ``q`` quantile by nearest rank (``q = 0.95``: the value that
    95 % of the samples do not exceed)."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def scans_per_s(completed: int, seconds: float) -> float:
    return completed / seconds


def pose_latencies(due: List[float], ready: List[Optional[float]],
                   window_end: float) -> List[float]:
    """Seconds from each scan's due time to its pose; a pose that never
    came counts at the window's end."""
    return [(r if r is not None else window_end) - d
            for d, r in zip(due, ready)]


class Run:
    def __init__(self, cell, seed: int, seconds: float, traced: bool,
                 device="cuda", t_process: Optional[float] = None,
                 scale: Optional[dict] = None):
        self.cell = cell
        self.cfg = dict(cell.config, **(scale or {}).get("config", {}))
        self.traffic = dict(cell.traffic, **(scale or {}).get("traffic", {}))
        self.check = dict(cell.check, **(scale or {}).get("check", {}))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.traced = traced
        self.device = torch.device(device)
        self.t_process = t_process if t_process is not None else \
            time.perf_counter()
        self.on_card = self.device.type == "cuda"

    # --------------------------------------------------------------- set-up
    def setup(self) -> None:
        clock = time.perf_counter
        split = self.setup_split = {"imports": clock() - self.t_process}
        t = clock()
        import norlab_icp_mapper_tpu_torch as nt
        if self.on_card:
            torch.cuda.reset_peak_memory_stats(self.device)
            if self.traced:
                trace.prime(self.device)
            torch.cuda.synchronize(self.device)
        split["context"], t = clock() - t, clock()
        tr = self.traffic
        scene = self.scene = Scene(self.cfg, self.device)
        # the warm-up laps, at a stride, then the window's laps
        lap = int(tr.get("warmup_laps", 1)) * scene.scans_per_lap
        stride = int(tr["warmup_stride"])
        self.warm_idx = list(range(0, lap, stride))
        if tr["loop"] == "open":
            n_window = int(math.ceil(tr["rate_hz"] * self.seconds))
        else:
            n_window = int(tr["window_laps"]) * scene.scans_per_lap
        self.window_idx = [lap + j for j in range(n_window)]
        # The map the robot had before the window (the set-up laps) comes
        # from the mix's fixed map seed, and so do the priors' errors; the
        # run's seed draws the window's range noise and the order in which
        # its scans get those errors: every seed the same work, in another
        # order.
        base = int(tr["map_seed"])
        rng = np.random.default_rng(self.seed)
        fixed = np.random.default_rng(base)
        self.truth = {j: scene.true_pose(j)
                      for j in self.warm_idx + self.window_idx}
        errors = [scene.perturb(np.eye(4), fixed)
                  for _ in self.warm_idx + self.window_idx]
        n_warm = len(self.warm_idx)
        order = list(range(n_warm)) + list(
            n_warm + rng.permutation(len(self.window_idx)))
        self.prior = {j: scene.with_error(self.truth[j], errors[e])
                      for j, e in zip(self.warm_idx + self.window_idx, order)}
        # the first scan's pose is the map's frame: the true one
        self.prior[self.warm_idx[0]] = self.truth[self.warm_idx[0]]
        self.raw = {}
        for idx, seed in ((self.warm_idx, base), (self.window_idx, self.seed)):
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            for s in range(0, len(idx), 64):
                scans = scene.ray_cast(idx[s:s + 64], gen)
                self.raw.update(zip(idx[s:s + 64], scans))
        all_idx = self.warm_idx + self.window_idx
        # the window's hand-over; the warm-up's last scans take it too
        pinned = tr["hand_over"] == "pinned_host" and self.on_card
        handed = set(self.window_idx) | set(self.warm_idx[-4:])
        mask = torch.ones(scene.rays, dtype=torch.bool, device=self.device)
        self.batches = {}
        for j in all_idx:
            pos = self.raw[j]
            if pinned and j in handed:
                self.batches[j] = nt.PointBatch(pos.cpu().pin_memory(),
                                                mask.cpu().pin_memory())
            else:
                self.batches[j] = nt.PointBatch(pos, mask)
        if self.on_card:
            torch.cuda.synchronize(self.device)
        split["data"], t = clock() - t, clock()
        self.stamp_ns = lambda j: int(round(j * 1e9 / scene.rate_hz))
        self.mapper = nt.Mapper(self.cfg["mapper_config"], is_3d=True,
                                is_online=bool(tr["online"]),
                                seed=base,
                                device=self.device)
        self.samples = self._draw_samples(rng)
        self.held: Dict[int, dict] = {}
        self.order: List[int] = []  # every scan handed over, in order
        self.stamps: List[int] = []  # and its stamp (ns)
        # the map's first scan is the start the per-scan judgement skips
        first = self.warm_idx[0]
        self._feed(first, self.batches[first])
        self.mapper.drain()
        self.held[first] = {"before": None, "after": self.mapper.map.local,
                            "bootstrap": True, "k": 0}
        split["first_scan"], t = clock() - t, clock()
        self._feed(self.warm_idx[1], self.batches[self.warm_idx[1]])
        self.mapper.drain()
        split["first_fused_scan"], t = clock() - t, clock()
        for j in self.warm_idx[2:]:
            self._feed(j, self.batches[j])
            if tr.get("pose_each_scan"):
                self.mapper.get_pose()
        self.mapper.drain()
        if self.on_card:
            torch.cuda.synchronize(self.device)
        gc.collect()
        gc.freeze()
        split["warm_lap"] = clock() - t

    def _draw_samples(self, rng) -> List[int]:
        """Window scans judged after the window, drawn from the seed among
        those the window surely reaches."""
        tr = self.traffic
        if tr["loop"] == "open":
            sure = len(self.window_idx)
        else:
            sure = min(len(self.window_idx),
                       int(tr["min_scans_per_s"] * self.seconds))
        k = min(int(self.check["sample_scans"]), sure - 1)
        pick = rng.choice(np.arange(1, sure), size=k, replace=False)
        return sorted(self.window_idx[int(i)] for i in pick)

    def _feed(self, j, batch):
        m = self.mapper
        filtered = m.apply_input_filters(batch)
        m.process_input(filtered, self.prior[j], self.stamp_ns(j))
        self.order.append(j)
        self.stamps.append(self.stamp_ns(j))

    # --------------------------------------------------------------- window
    def window(self) -> dict:
        m, tr = self.mapper, self.traffic
        waits0 = dict(m.waits)
        captures0 = m.icp.graph_captures
        m.timer.enabled = self.traced
        self.map_points = [m.map.known_count()]
        t_slice = tr.get("trace_slice", [30, 20])
        prof = None
        n_done, failed = 0, 0
        due, ready, late = [], [], []
        self.t_scans = []  # when each process_input returned
        self.setup_s = time.perf_counter() - self.t_process
        t0 = time.perf_counter()
        n = len(self.window_idx)
        j = 0
        error = None
        handed = None
        run_left, first = 0, None  # scans still to hold in a held run
        try:
            while True:
                now = time.perf_counter()
                if tr["loop"] == "open":
                    if j >= n:
                        break
                    d = t0 + j / tr["rate_hz"]
                    if d - now > 0.002:
                        time.sleep(d - now - 0.002)
                    while time.perf_counter() < d:
                        pass
                    due.append(d)
                    late.append(time.perf_counter() - d)
                elif now - t0 >= self.seconds:
                    break
                if self.traced and j == t_slice[0]:
                    prof = trace.start()
                    win = trace.span("window", True)
                    win.__enter__()
                idx = self.window_idx[j % n]
                if j < n and idx in self.samples:
                    run_left, first = int(self.check.get("hold_run", 1)), idx
                held = run_left > 0
                if handed is not None:  # the state the held scan left
                    self.held[handed]["next"] = m.map.local
                    handed = None
                if held:
                    before = m.map.local
                with trace.span("hand_over", prof is not None):
                    filtered = m.apply_input_filters(self.batches[idx])
                # stamps keep rising when the window wraps around its laps
                stamp = self.stamp_ns(self.window_idx[0] + j)
                with trace.span("process_input", prof is not None):
                    m.process_input(filtered, self.prior[idx], stamp)
                self.order.append(idx)
                self.stamps.append(stamp)
                self.t_scans.append(time.perf_counter())
                if held:
                    self.held[idx] = {"before": before, "after": m.map.local,
                                      "ref": m.icp._ref,
                                      "k": len(self.order) - 1,
                                      "solve": idx == first}
                    handed = idx
                    run_left -= 1
                if tr.get("pose_each_scan"):
                    with trace.span("get_pose", prof is not None):
                        m.get_pose()
                    ready.append(time.perf_counter())
                j += 1
                if prof is not None and j == t_slice[0] + t_slice[1]:
                    m.drain()
                    win.__exit__(None, None, None)
                    prof.stop()
                    self.profile = trace.summarize(prof)
                    self.slice_map = m.map.known_count()
                    prof = None
            m.drain()
            self.map_points.append(m.map.known_count())
        except RuntimeError as e:  # the mapper's state is lost
            error = e
        t1 = time.perf_counter()
        if prof is not None:
            prof.stop()
        n_done = j if error is None else max(0, j - m.PIPELINE_DEPTH - 1)
        failed = j - n_done
        self.error = error
        self.attempted, self.failed = j, failed
        self.t_window = t1 - t0
        out = {"setup_s": self.setup_s}
        if tr["loop"] == "open":
            ready = ready + [None] * (len(due) - len(ready))
            if error is not None:
                ready[n_done:] = [None] * (len(ready) - n_done)
            lat = pose_latencies(due, ready, t1)
            out["pose_latency_p95_ms"] = 1e3 * nearest_rank(lat, 0.95)
            self.latencies, self.lateness = lat, late
        else:
            out["scans_per_s"] = scans_per_s(n_done, t1 - t0)
        self.window_counts = {
            "scans": j,
            "waits": {k: m.waits[k] - waits0.get(k, 0) for k in m.waits},
            "graph_captures": m.icp.graph_captures - captures0,
            "phases_ms": m.timer.totals() if self.traced else {},
        }
        return out
