"""The harness's pieces: finding cells by name, the generator, the
end-to-end arithmetic, the roofline's byte count, and what it imports."""
import ast
import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from harness import manifest, readers
from harness.cell import nearest_rank, pose_latencies, scans_per_s
from harness.scene import Scene

BENCH = Path(__file__).resolve().parent.parent


def small_config(**sensor):
    cfg = manifest.config("os1_p2plane")
    cfg["sensor"] = dict(cfg["sensor"], beams=8, columns=64, **sensor)
    return cfg


def test_entries_added_as_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "port_bench"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    man = json.loads((BENCH.parent / "BENCHMARK.json").read_text())
    cfg = manifest.config("os1_p2plane")
    cfg["name"] = "os0_p2plane"
    (bench / "configs" / "os0_p2plane.json").write_text(json.dumps(cfg))
    mix = dict(manifest.traffic("online_10hz"), rate_hz=5)
    (bench / "traffic" / "online_5hz.json").write_text(json.dumps(mix))
    (bench / "checks" / "os0_online_5hz.json").write_text(json.dumps(
        {"sample_scans": 4, "limits": {"pose_gap_median_mm": 1.0}}))
    (bench / "metrics" / "scans_seen.online.py").write_text(
        "def read(ctx):\n    return float(ctx.scans)\n")
    man["configs"].append(dict(man["configs"][0], name="os0_p2plane",
                               file="port_bench/configs/os0_p2plane.json"))
    man["workloads"].append({"name": "os0_online_5hz",
                             "config": "os0_p2plane", "traffic": "online_5hz",
                             "chips": 1, "why": "a test"})
    man["end_to_end"].append({"name": "pose_latency_p95_ms", "unit": "ms",
                              "better": "lower", "bound": 0.25,
                              "source": "host_clock",
                              "workloads": ["os0_online_5hz"]})
    man["per_layer"].append({"name": "scans_seen.online", "unit": "scans",
                             "better": "higher", "source": "program_counter",
                             "layer": "device", "moves": "pose_latency_p95_ms",
                             "workloads": ["os0_online_5hz"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.Cell(manifest.load_manifest(root), "os0_online_5hz",
                         bench)
    assert cell.config["name"] == "os0_p2plane"
    assert cell.traffic["rate_hz"] == 5
    assert sorted(m["name"] for m in cell.end_to_end) == [
        "pose_latency_p95_ms", "setup_s"]
    readers_ = cell.readers()
    assert readers_["scans_seen.online"](SimpleNamespace(scans=7)) == 7.0
    assert set(readers_) == {"scans_seen.online"}  # the others list cells
    assert "scans_per_s" not in [m["name"] for m in cell.end_to_end]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    man = manifest.load_manifest()
    for w in man["workloads"]:
        cell = manifest.Cell(man, w["name"])
        names = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names
        assert set(cell.readers()) == {m["name"] for m in cell.per_layer}


def test_scans_repeat_for_a_seed_and_differ_across_seeds():
    scene = Scene(small_config(), "cpu")

    def scans(seed):
        g = torch.Generator().manual_seed(seed)
        rng = np.random.default_rng(seed)
        prior = scene.perturb(scene.true_pose(5), rng)
        return scene.ray_cast([0, 5, 700], g), prior

    (a, pa), (b, pb), (c, pc) = scans(3_000_000_019), \
        scans(3_000_000_019), scans(17)
    assert torch.equal(a, b) and np.array_equal(pa, pb)
    assert not torch.equal(a, c) and not np.array_equal(pa, pc)
    # the noise differs, the work does not: every ray hits, same stamps
    assert torch.isfinite(a).all() and torch.isfinite(c).all()
    assert (a - c).abs().max() < 0.2


def test_patrol_keeps_clear_of_boxes_and_walls():
    scene = Scene(manifest.config("os1_p2plane"), "cpu")
    boxes = np.asarray(manifest.config("os1_p2plane")["scene"]["boxes"])
    assert scene.scans_per_lap == 444  # 66.6 m at 0.15 m a scan
    for j in range(0, scene.scans_per_lap, 3):
        x, y, _ = scene.loop.at(j * scene.step_m)
        for b in boxes:
            dx = max(b[0] - x, 0, x - b[1])
            dy = max(b[2] - y, 0, y - b[3])
            assert (dx * dx + dy * dy) ** 0.5 >= 1.0
        assert min(x, 60 - x, y, 25 - y) >= 1.0


def test_scans_per_s_counts_the_whole_window():
    assert scans_per_s(300, 10.0) == 30.0
    # a stall of 2 s in a 10 s window costs its share
    assert scans_per_s(240, 12.0) < scans_per_s(300, 10.0)


def test_pose_latency_p95_moves_with_a_stall_and_a_missing_pose():
    due = [0.1 * j for j in range(100)]
    ready = [d + 0.030 for d in due]
    base = nearest_rank(pose_latencies(due, ready, 10.5), 0.95)
    assert base == pytest.approx(0.030)
    # a 0.5 s stall at scan 50 delays it and the scans queued behind it
    stalled = list(ready)
    for j in range(50, 56):
        stalled[j] = max(stalled[j], 5.0 + 0.5 + 0.03 * (j - 49))
    assert nearest_rank(pose_latencies(due, stalled, 10.5), 0.95) > 0.1
    # a pose that never comes counts at the window's end
    lost = list(ready)
    for j in range(90, 96):
        lost[j] = None
    lat = pose_latencies(due, lost, 10.5)
    assert max(lat) == pytest.approx(10.5 - 9.0)
    assert nearest_rank(lat, 0.95) > 0.5


def test_nn_roofline_counts_the_same_work_for_both_kernels():
    shapes = {"scan_rows": 65536, "map_valid": 170_000}
    sweep = readers.nn_call_bytes("sweep_knn", 3, 1, shapes)
    brute = readers.nn_call_bytes("knn_brute", 3, 1, shapes)
    assert sweep == brute == 65536 * 13 + 170_000 * 12 + 65536 * 8
    ctx = SimpleNamespace(shapes=shapes, profile={
        "kernels": {"void (anonymous namespace)::sweep_knn_kernel<3, 1>(x)":
                    1e-3,
                    "void (anonymous namespace)::knn_brute_kernel<3, 1, 4>(x)":
                    1e-3},
        "kernel_calls": {
            "void (anonymous namespace)::sweep_knn_kernel<3, 1>(x)": 1,
            "void (anonymous namespace)::knn_brute_kernel<3, 1, 4>(x)": 1}})
    pct = readers.nn_roofline_pct(ctx, ("sweep_knn", "knn_brute"))
    assert pct == pytest.approx(100 * sweep / readers.PEAK_HBM_BYTES / 1e-3)
    assert 0 < pct < 100
    ctx.profile = {"kernels": {}, "kernel_calls": {}}
    assert readers.nn_roofline_pct(ctx, ("sweep_knn",)) is None


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_imports_jax_and_the_reference_nothing_of_the_port():
    jax_side = {"jax", "jaxlib", "flax", "norlab_icp_mapper_tpu"}
    files = [p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts]
    assert files
    for p in files:
        assert not set(_imports(p)) & jax_side, p
    for p in (BENCH / "reference").glob("*.py"):
        assert "norlab_icp_mapper_tpu_torch" not in set(_imports(p)), p


def test_the_result_refuses_a_loaded_jax(monkeypatch):
    import sys
    from harness import outcome
    monkeypatch.setitem(sys.modules, "norlab_icp_mapper_tpu.fake",
                        SimpleNamespace())
    assert outcome.forbidden_modules() == ["norlab_icp_mapper_tpu"]
    monkeypatch.delitem(sys.modules, "norlab_icp_mapper_tpu.fake")
    monkeypatch.setitem(sys.modules, "norlab_icp_mapper_tpu_torch_x",
                        SimpleNamespace())
    assert "norlab_icp_mapper_tpu" not in outcome.forbidden_modules()
