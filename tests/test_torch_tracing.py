"""The port's tracer, ``fused.PhaseTimer``, and where the Mapper uses it
(CPU).

The timer keeps four kinds of name in one flat dict: device spans under
their own name, host spans under ``host.``, blocking reads under ``wait.``
and counters under ``count.``; every span is also a ``mapper.<name>``
profiler range.  Disabled, it records nothing and opens no range.  The
Mapper times every wait it counts in ``waits`` (the ``mapper.wait.<cause>``
ranges of a drive equal the change in ``waits[cause]``), counts the ICP
iterations it harvests, and counts the same waits with the timer on or off.

The drives run ``Mapper(None)`` (the ``distance`` condition, one decision
read a scan) on scans of at most 1024 points and a map under 2048.  On the
CPU a scan's mirrors land at once; the ``in_flight`` drives make them never
ready and keep a one-scan pipeline, as on a card whose solve is still
running, so that the ``pipeline_depth`` and ``capacity`` waits fire too.
"""
import collections

import numpy as np
import pytest
import torch

import norlab_icp_mapper_tpu_torch as nt
from norlab_icp_mapper_tpu_torch import mapper as mapper_mod
from norlab_icp_mapper_tpu_torch.fused import PhaseTimer

from test_torch_mapper_e2e import make_world, pose_at, scan_at

XS = [2.0, 2.6, 3.2, 3.8, 4.4, 5.0, 5.6, 6.2]  # a merge every second scan
CPU = torch.device("cpu")


def _profiled():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _ranges(prof):
    return collections.Counter(e.name for e in prof.events()
                               if e.name.startswith("mapper."))


def _spans(timer):
    with timer.phase("solve", CPU):
        with timer.phase("icp_solve", CPU):
            pass
    with timer.host("process_input"):
        with timer.wait("merge_decision"):
            pass
    timer.count("icp_iterations", 3)
    timer.count("icp_iterations", 4)


def test_spans_and_counters_land_under_their_prefixes():
    timer = PhaseTimer()
    timer.enabled = True
    _spans(timer)
    kept = timer.totals(reset=False)
    assert set(kept) == {"solve", "icp_solve", "host.process_input",
                         "wait.merge_decision", "count.icp_iterations"}
    assert kept["count.icp_iterations"] == 7
    assert kept["icp_solve"] <= kept["solve"]
    assert kept["wait.merge_decision"] <= kept["host.process_input"]
    assert all(v >= 0 for v in kept.values())
    assert timer.totals() == pytest.approx(kept)  # reset=False kept them
    assert timer.totals() == {}  # the default reset cleared spans and counts


def test_disabled_spans_are_one_shared_null_context():
    timer = PhaseTimer()
    off = timer.phase("solve", CPU)
    assert off is timer.host("process_input") is timer.wait("shrink")
    with off:
        pass
    assert timer.count("icp_iterations", 5) is None
    assert timer._events == [] and timer._counts == {}


def test_only_an_enabled_timer_opens_ranges():
    timer = PhaseTimer()
    with _profiled() as prof:
        _spans(timer)
    assert _ranges(prof) == {}
    assert timer.totals() == {}
    timer.enabled = True
    with _profiled() as prof:
        _spans(timer)
    assert _ranges(prof) == {"mapper.solve": 1, "mapper.icp_solve": 1,
                             "mapper.host.process_input": 1,
                             "mapper.wait.merge_decision": 1}


def _drive(monkeypatch, timed: bool, in_flight: bool):
    """``Mapper(None)`` over ``XS``; per scan the timer's totals, and the
    sum of the scans' ICP iterations."""
    if in_flight:
        monkeypatch.setattr(mapper_mod._Mirror, "ready", lambda self: False)
    world = make_world(np.random.default_rng(42), n=300)
    m = nt.Mapper(None, device="cpu")
    m.timer.enabled = timed
    if in_flight:
        m.PIPELINE_DEPTH = 1
    per_scan, iterations = [], 0
    for i, x in enumerate(XS):
        scan = scan_at(world, pose_at(x))
        assert scan.shape[0] <= 1024
        filtered = m.apply_input_filters(
            nt.PointBatch.from_numpy(scan, device="cpu"))
        m.process_input(filtered, pose_at(x), i * int(1e8))
        iterations += int(m.last_iterations)
        per_scan.append(m.timer.totals())
    m.drain()
    for k, v in m.timer.totals().items():  # what drain() harvested
        per_scan[-1][k] = per_scan[-1].get(k, 0) + v
    assert m.map.known_count() < 2048
    return m, per_scan, iterations


@pytest.mark.parametrize("in_flight", [False, True],
                         ids=["mirrors_landed", "mirrors_in_flight"])
def test_a_drive_times_every_counted_wait(monkeypatch, in_flight):
    with _profiled() as prof:
        m, per_scan, iterations = _drive(monkeypatch, True, in_flight)
    ranges = _ranges(prof)
    fired = {c for c, n in m.waits.items() if n}  # a new Mapper counts 0
    assert "merge_decision" in fired
    if in_flight:
        assert {"pipeline_depth", "capacity"} <= fired
    for cause in m.waits:
        assert ranges.get(f"mapper.wait.{cause}", 0) == m.waits[cause], cause
    assert ranges["mapper.host.process_input"] == len(XS)
    assert ranges["mapper.host.input_filters"] == len(XS)
    # the first scan builds the map: no solve; every later one solves
    assert ranges["mapper.icp_solve"] == ranges["mapper.solve"] == len(XS) - 1
    total = collections.Counter()
    for i, t in enumerate(per_scan):
        total.update(t)
        waited = sum(v for k, v in t.items() if k.startswith("wait."))
        assert waited <= t["host.process_input"]
        if i:
            assert 0 < t["icp_solve"] <= t["solve"]
    assert iterations > 0
    assert total["count.icp_iterations"] == iterations


@pytest.mark.parametrize("in_flight", [False, True],
                         ids=["mirrors_landed", "mirrors_in_flight"])
def test_waits_are_the_same_with_the_timer_on_and_off(monkeypatch, in_flight):
    on, timed, _ = _drive(monkeypatch, True, in_flight)
    off, untimed, _ = _drive(monkeypatch, False, in_flight)
    assert on.waits == off.waits
    assert all(t == {} for t in untimed) and all(timed)
    for a, b in zip(on.get_trajectory().poses, off.get_trajectory().poses):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
