"""What decides ``correct``, driven on the CPU at a small size: a whole run
of a cell past the look for a card, once sound and once for each fault
the cells can have, planted in the program underneath; and the control,
the plain reference in the program's place with TF32 matrix products.

The limits here are the configuration's, raised to twice what a sound run
at this size reads where that is more (a scan of 1,024 rays reads higher
than one of 65,536): each fault must still come out not correct."""
import io
import json
from contextlib import redirect_stdout

import pytest

import control
import run as bench
from harness import faults, manifest

SMALL = {"beams": 8, "columns": 128}
SEED = 3_000_000_019
# the benchmark's cell, and the point-to-plane configuration's judgement
# (octree merge, DynamicPoints, normals), on a cell of this file's own
CELLS = ("default_offline", "p2plane_offline")


def _manifest():
    man = manifest.load_manifest()
    if not any(w["name"] == "p2plane_offline" for w in man["workloads"]):
        man["workloads"].append({"name": "p2plane_offline",
                                 "config": "os1_p2plane",
                                 "traffic": "offline_replay", "chips": 1,
                                 "why": "the octree judgement"})
        for m in man["end_to_end"]:
            if m["name"] == "scans_per_s":
                m["workloads"].append("p2plane_offline")
    return man


def _cell(name):
    bench = manifest.BENCH_DIR
    cell = manifest.Cell.__new__(manifest.Cell)
    man = _manifest()
    entry = next(w for w in man["workloads"] if w["name"] == name)
    cell.entry, cell.name, cell.chips = entry, name, 1
    cell.config = manifest.config(entry["config"], bench)
    cell.traffic = manifest.traffic(entry["traffic"], bench)
    path = bench / "checks" / f"{name}.json"
    cell.check = (json.loads(path.read_text()) if path.exists()
                  else {"sample_scans": 4, "limits": {}})
    cell.end_to_end = [m for m in man["end_to_end"]
                       if name in m.get("workloads", [name])]
    cell.per_layer = []
    return cell


def scale(cell, limits=None):
    """A small room, a short loop and a sparse sensor: a run the CPU
    holds."""
    cfg = cell.config
    out = {"config": {
        "sensor": dict(cfg["sensor"], **SMALL),
        "scene": {"hall": [[0.0, 24.0], [0.0, 12.0], [0.0, 4.0]],
                  "boxes": [[11.0, 13.0, 5.0, 7.0, 0.0, 2.0]],
                  "yaw_deg": 30.0},
        "trajectory": dict(cfg["trajectory"], speed_mps=6.0,
                           corners=[[5.0, 2.5], [19.0, 2.5], [19.0, 9.5],
                                    [5.0, 9.5]])},
        "traffic": {"window_laps": 1, "warmup_laps": 1, "warmup_stride": 3,
                    "min_scans_per_s": 1.5},
        "check": {"sample_scans": 2, "hold_run": 3}}
    if limits is not None:
        out["check"]["limits"] = limits
    return out


def run_cell(name, limits=None, seconds=6.0):
    cell = _cell(name)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(["--workload", name, "--seed", str(SEED),
                         "--seconds", str(seconds), "--trace", "0"],
                        device="cpu", scale=scale(cell, limits), cell=cell)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def calibrated(name):
    """The cell's limits, or twice a sound small run's readings (at least
    1e-3), whichever is more."""
    sound = run_cell(name, {k: 1e9 for k in NUMBERS[name]})
    limits = _cell(name).check["limits"]
    return {k: max(limits.get(k, 0.0), 2 * sound["checks"][k]["value"],
                   1e-3) for k in NUMBERS[name]}


NUMBERS = {
    "default_offline": ("pose_gap_median_mm", "merge_miss_share",
                        "handover_miss_share", "ref_normal_miss_share"),
    "p2plane_offline": ("pose_gap_median_mm", "merge_miss_share",
                        "handover_miss_share", "prob_miss_share",
                        "normal_miss_share"),
}


@pytest.fixture(scope="module")
def limits():
    return {name: calibrated(name) for name in CELLS}


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name, limits):
    assert run_cell(name, limits[name])["correct"]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_fault_in_the_timed_path_is_not_correct(name, fault, limits,
                                                  monkeypatch):
    faults.plant(fault, monkeypatch.setattr)
    out = run_cell(name, limits[name])
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(name, limits):
    cell = _cell(name)
    line = control.readings(cell, SEED, 6.0, "cpu", True, scale(cell))
    failed = [k for k, v in limits[name].items() if line["control"][k] > v]
    assert failed, line


@pytest.mark.card
def test_a_cell_runs_on_the_card(card):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = bench.main(["--workload", "default_offline", "--seed", "7",
                         "--seconds", "2", "--trace", "0"])
    assert rc == 0
    line = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert line["device"]["platform"] == "gpu" and line["correct"]
