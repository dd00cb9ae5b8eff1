"""Tracing, profiling and overflow records.

  - ``StageTimer``: stage timers on the host clock; with ``sync=True`` each
    stage ends by waiting for a CUDA event recorded behind its work, so the
    host time covers the device's, and the device time between the stage's
    two events is kept beside it.
  - ``trace(name)``: a ``torch.profiler.record_function`` range, so that
    stages show up in device profiles.
  - ``start_profiler(logdir)`` / ``stop_profiler()``: one ``torch.profiler``
    session that writes a Chrome trace into ``logdir``.
  - ``IterationInspector``: libpointmatcher's VTKFileInspector analog:
    records per-iteration (residual, overlap) and optionally dumps the moved
    reading of every iteration as a VTK file.
  - overflow records: every capacity-bounded pass (sweep windows, insert
    headroom) reports its overflow count through :func:`record_overflow`,
    so that no cap is silent.

The overflow sink is off by default (``record_overflow`` does nothing).
Unlike the JAX package's, whose sink receives host ints from a device
callback, this sink receives the count as the pass produced it: a 0-d
tensor on the pass's device.  :func:`accumulate_overflow` adds it into a
counter per name without reading it, so a steady loop with the sink
installed makes no blocking host read; :func:`overflow_totals` reads each
counter once.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["StageTimer", "trace", "start_profiler", "stop_profiler",
           "IterationInspector", "set_overflow_sink", "accumulate_overflow",
           "record_overflow", "overflow_totals", "recording_overflow"]


# ------------------------------------------------------------------ caps
_overflow_sink = None
_overflow_totals: Dict[str, object] = {}


def set_overflow_sink(fn) -> None:
    """Install ``fn(name: str, value)`` as the overflow sink (None to
    disable).  ``value`` is a 0-d tensor on the device of the pass that
    counted it (or an int).  Pass ``set_overflow_sink(accumulate_overflow)``
    to count into ``overflow_totals()``."""
    global _overflow_sink
    _overflow_sink = fn


def recording_overflow() -> bool:
    """True when a sink is installed: a pass whose count costs work of its
    own computes it only then."""
    return _overflow_sink is not None


def accumulate_overflow(name: str, value) -> None:
    """Add ``value`` to the counter of ``name``; a tensor stays on its
    device (the addition is a launch, never a host read)."""
    if isinstance(value, torch.Tensor):
        value = value.detach().to(torch.int64)
    else:
        value = int(value)
    _overflow_totals[name] = _overflow_totals.get(name, 0) + value


def overflow_totals() -> Dict[str, int]:
    """Every counter as a host int (one read of each)."""
    return {k: int(v) for k, v in _overflow_totals.items()}


def record_overflow(name: str, value) -> None:
    """Report an overflow count to the sink, if one is installed."""
    sink = _overflow_sink
    if sink is not None:
        sink(name, value)


# ---------------------------------------------------------------- timers
class StageTimer:
    def __init__(self, sync: bool = True):
        self.sync = sync
        self.records: Dict[str, List[float]] = defaultdict(list)
        # device seconds between a stage's two CUDA events (sync=True)
        self.device_records: Dict[str, List[float]] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        """Time the block; yields a dict the block may ignore (the JAX
        package's signature, where a ``"result"`` entry was waited for)."""
        start = None
        if self.sync and torch.cuda.is_available():
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        out = {}
        try:
            yield out
        finally:
            if start is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                end.synchronize()
                self.device_records[name].append(
                    start.elapsed_time(end) * 1e-3)
            self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, vals in self.records.items():
            v = np.asarray(vals) * 1e3
            out[name] = {
                "count": len(vals),
                "p50_ms": float(np.percentile(v, 50)),
                "p90_ms": float(np.percentile(v, 90)),
                "total_ms": float(v.sum()),
            }
            if self.device_records.get(name):
                out[name]["device_total_ms"] = float(
                    np.sum(self.device_records[name]) * 1e3)
        return out

    def report(self) -> str:
        lines = [f"{'stage':<24}{'n':>6}{'p50 ms':>10}{'p90 ms':>10}"
                 f"{'total ms':>11}"]
        for name, s in sorted(self.summary().items(),
                              key=lambda kv: -kv[1]["total_ms"]):
            lines.append(f"{name:<24}{s['count']:>6}{s['p50_ms']:>10.1f}"
                         f"{s['p90_ms']:>10.1f}{s['total_ms']:>11.0f}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(name: str):
    with torch.profiler.record_function(name):
        yield


_profiler: Optional[torch.profiler.profile] = None


def start_profiler(logdir: str):
    """Start one profiler session; :func:`stop_profiler` writes its Chrome
    trace into ``logdir``."""
    global _profiler
    if _profiler is not None:
        raise RuntimeError("start_profiler: a session is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    _profiler = torch.profiler.profile(
        activities=acts,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    _profiler.start()


def stop_profiler():
    global _profiler
    if _profiler is None:
        return
    prof, _profiler = _profiler, None
    prof.stop()


class IterationInspector:
    """Per-registration diagnostics (lpm ``VTKFileInspector`` analog).

    The ICP engine runs an inspected registration one iteration per solve
    (``ICPEngine._solve_inspected``) and records each here -- a debug path,
    not the production solve.
    """

    def __init__(self, dump_dir: Optional[str] = None):
        self.dump_dir = dump_dir
        self.history: List[Dict[str, float]] = []

    def record(self, iteration: int, overlap: float, residual: float,
               cloud=None):
        self.history.append({"iteration": iteration, "overlap": overlap,
                             "residual": residual})
        if self.dump_dir is not None and cloud is not None:
            from ..io.vtk import write_vtk
            os.makedirs(self.dump_dir, exist_ok=True)
            data = cloud.to_numpy()
            desc = {k: v for k, v in data.items() if k != "positions"}
            write_vtk(os.path.join(self.dump_dir, f"iter_{iteration:03d}.vtk"),
                      data["positions"], desc)
