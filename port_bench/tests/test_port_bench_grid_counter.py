"""``nn_grid_fallback_pct.offline``: the grid matcher's fallback queries
over its valid queries, from the counters the Mapper adds to
``PhaseTimer`` at harvest."""
from types import SimpleNamespace

import pytest

from harness import manifest

NAME = "nn_grid_fallback_pct.offline"


@pytest.fixture
def read():
    return manifest.metric_reader(NAME)


def test_share_of_the_valid_queries(read):
    ctx = SimpleNamespace(phases_ms={"count.nn_grid_queries": 40_000,
                                     "count.nn_grid_fallbacks": 10,
                                     "icp_solve": 123.0})
    assert read(ctx) == pytest.approx(0.025)
    ctx.phases_ms["count.nn_grid_fallbacks"] = 0
    assert read(ctx) == 0.0


@pytest.mark.parametrize("phases", [{}, {"icp_solve": 5.0},
                                    {"count.nn_grid_queries": 0}])
def test_nothing_where_the_program_has_no_grid_counters(read, phases):
    assert read(SimpleNamespace(phases_ms=phases)) is None


def test_the_manifest_lists_it_for_default_offline_in_the_kernels_layer():
    man = manifest.load_manifest()
    entries = {m["name"]: m for m in man["per_layer"]}
    m = entries[NAME]
    assert m["workloads"] == ["default_offline"]
    assert (m["unit"], m["better"], m["source"], m["moves"]) == (
        "%", "lower", "program_counter", "scans_per_s")
    assert m["layer"] == entries["nn_roofline_pct.offline"]["layer"]
    assert NAME in manifest.Cell(man, "default_offline").readers()
