"""Finds a cell's parts by the names ``BENCHMARK.json`` gives them.

* a configuration is ``configs/<name>.json``;
* a traffic mix is ``traffic/<name>.json``, parameters that the one loop
  (``harness/cell.py``) reads;
* a per-layer metric is ``metrics/<name>.py`` with ``read(ctx)``, which
  returns a number or None when it finds nothing to read;
* a cell's judgement is ``checks/<cell>.json``: how many scans to judge,
  and the limit of each number compared, with the readings it was set
  from.

A configuration, a mix or a metric is added as files and an entry in
``BENCHMARK.json``; no file of the harness names them.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_manifest(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "configs" / f"{name}.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return _json(bench_dir / "traffic" / f"{name}.json")


def metric_reader(name: str, bench_dir: Path = BENCH_DIR) -> Callable:
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "port_bench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """One entry of ``workloads`` with its configuration, mix and metrics."""

    def __init__(self, manifest: dict, workload: str,
                 bench_dir: Path = BENCH_DIR):
        cells = {w["name"]: w for w in manifest["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"there are {sorted(cells)}")
        self.entry = cells[workload]
        self.name = workload
        self.chips = int(self.entry["chips"])
        self.config = config(self.entry["config"], bench_dir)
        self.traffic = traffic(self.entry["traffic"], bench_dir)
        self.check = _json(bench_dir / "checks" / f"{workload}.json")
        self.end_to_end: List[dict] = [
            m for m in manifest["end_to_end"] if self._reports(m)]
        self.per_layer: List[dict] = [
            m for m in manifest["per_layer"] if self._reports_layer(m)]
        self._bench_dir = bench_dir

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def _reports_layer(self, metric: dict) -> bool:
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return any(m["name"] == metric["moves"] for m in self.end_to_end)

    def readers(self) -> Dict[str, Callable]:
        return {m["name"]: metric_reader(m["name"], self._bench_dir)
                for m in self.per_layer}

    def unit(self, name: str) -> Optional[str]:
        for m in self.end_to_end + self.per_layer:
            if m["name"] == name:
                return m["unit"]
        return None
