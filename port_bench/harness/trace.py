"""The device trace of a traced run: ``torch.profiler`` over a slice of the
window, marked by the harness's own ``bench.*`` spans.

From the trace's events: the device's busy time (the union of its
kernels, copies and sets) inside the ``bench.window`` span, the span's
length, the device time of each kernel, the operations that took most
time, and the longest idle gaps named by what the host was doing then
(the ``bench.*`` span and the outermost ``aten`` operation around the
gap's middle).
"""
from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW_SPAN = "bench.window"


def span(name: str, on: bool):
    """A ``bench.<name>`` range in the trace when ``on``."""
    if not on:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"bench.{name}")


def prime(device) -> None:
    """One short profiler session before any CUDA graph is captured: a
    WHILE node's body shows every iteration in the trace only in a graph
    captured after the process's first session."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        (torch.zeros(1, device=device) + 1).sum()
    torch.cuda.synchronize(device)


def start():
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    return prof


def _is_device_work(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    return not (e.is_user_annotation() or e.name().startswith("bench."))


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def summarize(prof, top: int = 10) -> Dict:
    """``{busy_s, window_s, kernels: {name: seconds}, kernel_calls: {name:
    launches}, device_ops, idle_gaps}`` of the events inside the ``bench.window`` span (None
    without the span)."""
    events = prof.profiler.kineto_results.events()
    win = [e for e in events if e.name() == WINDOW_SPAN
           and e.device_type() == torch.autograd.DeviceType.CPU]
    if not win:
        return None
    w0, w1 = win[0].start_ns(), win[0].end_ns()
    thread = win[0].start_thread_id()
    dev, spans, ops = [], [], []
    for e in events:
        s, t = e.start_ns(), e.end_ns()
        if t < w0 or s > w1:
            continue
        if _is_device_work(e):
            dev.append((max(s, w0), min(t, w1), e.name()))
        elif (e.device_type() == torch.autograd.DeviceType.CPU
              and e.start_thread_id() == thread):
            if e.name().startswith("bench.") and e.name() != WINDOW_SPAN:
                spans.append((s, t, e.name()))
            elif e.name().startswith("aten::"):
                ops.append((s, t, e.name()))
    busy = _union([(s, t) for s, t, _ in dev])
    by_kernel: Dict[str, float] = defaultdict(float)
    calls: Dict[str, int] = defaultdict(int)
    for s, t, name in dev:
        by_kernel[name] += (t - s) * 1e-9
        calls[name] += 1
    # idle gaps, named by the host's span and outermost op at their middle
    spans.sort()
    ops.sort()
    outer, end = [], -1
    for s, t, name in ops:
        if s >= end:
            outer.append((s, t, name))
            end = t
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        g0, g1 = edges[i], edges[i + 1]
        if g1 <= g0:
            continue
        mid = (g0 + g1) // 2
        gaps[_host_at(mid, spans, outer)] += (g1 - g0) * 1e-9
    rank = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
    return {"busy_s": sum(t - s for s, t in busy) * 1e-9,
            "window_s": (w1 - w0) * 1e-9,
            "kernels": dict(by_kernel), "kernel_calls": dict(calls),
            "device_ops": [list(kv) for kv in rank(by_kernel)],
            "idle_gaps": [list(kv) for kv in rank(gaps)]}


def _containing(t: int, ivs) -> str:
    """The name of the interval of ``ivs`` (sorted, not nested) around
    ``t``, or ''."""
    i = bisect.bisect_right(ivs, (t, float("inf"), "")) - 1
    if i >= 0 and ivs[i][0] <= t <= ivs[i][1]:
        return ivs[i][2]
    return ""


def _host_at(t: int, spans, outer) -> str:
    sp = _containing(t, spans) or "outside_bench_spans"
    op = _containing(t, outer)
    return f"{sp} / {op}" if op else sp
