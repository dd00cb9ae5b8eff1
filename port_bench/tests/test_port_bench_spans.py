"""The per-layer metrics that read ``PhaseTimer``'s host spans, waits and
iteration counter: each one's arithmetic on a made-up window, and nothing
read where the program has no such span (a program without them, or an
untraced run)."""
from types import SimpleNamespace

import pytest

from harness import manifest

NEW = ("host_wait_ms_per_scan.offline", "host_dispatch_ms_per_scan.offline",
       "solve_ms_per_iteration.offline")

WINDOW = {"solve": 2100.0, "icp_solve": 1800.0, "merge": 200.0,
          "host.process_input": 2050.0, "host.input_filters": 40.0,
          "wait.merge_decision": 1700.0, "wait.pipeline_depth": 60.0,
          "wait.capacity": 20.0, "count.icp_iterations": 450}
OLD = {"solve": 2100.0, "merge": 200.0}  # the phases before the host spans


def ctx(phases_ms, scans=20):
    return SimpleNamespace(scans=scans, phases_ms=phases_ms,
                           waits={"merge_decision": scans})


@pytest.fixture(scope="module")
def read():
    return {name: manifest.metric_reader(name) for name in NEW}


def test_host_wait_is_the_wait_spans_per_scan(read):
    f = read["host_wait_ms_per_scan.offline"]
    assert f(ctx(WINDOW)) == pytest.approx((1700 + 60 + 20) / 20)
    no_waits = {k: v for k, v in WINDOW.items() if not k.startswith("wait.")}
    assert f(ctx(no_waits)) == 0.0


def test_host_dispatch_is_the_host_spans_less_their_waits(read):
    f = read["host_dispatch_ms_per_scan.offline"]
    assert f(ctx(WINDOW)) == pytest.approx(
        (2050 + 40 - (1700 + 60 + 20)) / 20)


def test_solve_per_iteration_is_icp_solve_over_the_count(read):
    f = read["solve_ms_per_iteration.offline"]
    assert f(ctx(WINDOW)) == pytest.approx(1800 / 450)
    assert f(ctx(dict(WINDOW, **{"count.icp_iterations": 0}))) is None


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("phases_ms", [OLD, {}], ids=["no_spans", "untraced"])
def test_nothing_read_without_the_spans(read, name, phases_ms):
    assert read[name](ctx(phases_ms)) is None


@pytest.mark.parametrize("name", NEW[:2])
def test_nothing_per_scan_without_scans(read, name):
    assert read[name](ctx(WINDOW, scans=0)) is None


def test_the_manifest_lists_them_for_default_offline_only():
    man = manifest.load_manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == ["default_offline"]
        assert (m["unit"], m["better"], m["source"], m["moves"]) == (
            "ms", "lower", "program_span", "scans_per_s")
    assert entries[NEW[0]]["layer"] == entries[NEW[1]]["layer"] \
        == entries["host_waits_per_scan.offline"]["layer"]
    assert entries[NEW[2]]["layer"] \
        == entries["solve_ms_per_scan.offline"]["layer"]
    cell = manifest.Cell(man, "default_offline")
    assert set(NEW) <= set(cell.readers())
