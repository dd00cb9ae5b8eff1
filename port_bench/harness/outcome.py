"""After the window: the per-layer metrics of a traced run, the judgement
of what the window produced, and the result line."""
from __future__ import annotations

import gc
import json
import sys
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from reference.judge import MergeRules, merge_decisions

FORBIDDEN = ("jax", "jaxlib", "flax", "norlab_icp_mapper_tpu")


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that a run of the port may not
    load (compared whole: the port's own name begins with the last)."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def layer_context(run) -> SimpleNamespace:
    """What the per-layer readers read."""
    wc = run.window_counts
    map_valid = getattr(run, "slice_map", None)
    return SimpleNamespace(
        scans=wc["scans"], waits=wc["waits"],
        graph_captures=wc["graph_captures"], phases_ms=wc["phases_ms"],
        profile=getattr(run, "profile", None),
        shapes={"scan_rows": run.scene.rays, "map_valid": map_valid})


def _rows(batch, with_desc: bool) -> Dict[str, torch.Tensor]:
    m = batch.mask
    out = {"pos": batch.positions[m].clone()}
    if with_desc and "normals" in batch.descriptors:
        out["normals"] = batch.descriptors["normals"][m].clone()
    if with_desc and "probabilityDynamic" in batch.descriptors:
        out["prob"] = batch.descriptors["probabilityDynamic"][m, 0].clone()
    return out


def collect(run) -> dict:
    """The window's outputs to judge, copied off the program's state:
    every scan's pose, and the held scans' maps before and after."""
    m = run.mapper
    poses = [np.asarray(p, np.float32) for p in m.trajectory.poses]
    if len(poses) != len(run.order):
        raise RuntimeError(f"{len(poses)} poses for {len(run.order)} scans")
    octree = MergeRules(run.cfg["mapper_config"]).octree
    expect, last = merge_decisions(run.cfg["mapper_config"], poses,
                                   [t * 1e-9 for t in run.stamps])
    samples = []
    memo = {}  # scans that share a map share its rows

    def rows(batch, with_desc):
        key = (id(batch), with_desc)
        if key not in memo:
            memo[key] = _rows(batch, with_desc)
        return memo[key]

    for j, h in run.held.items():
        k = h["k"]
        before = (rows(h["before"], octree) if h["before"] is not None
                  else {"pos": torch.zeros((0, 3), device=run.device),
                        "prob": torch.zeros(0, device=run.device)})
        samples.append({"j": j, "k": k, "scan": run.raw[j],
                        "prior": run.prior[j], "pose": poses[k],
                        "before": before, "after": rows(h["after"], octree),
                        "next": (rows(h["next"], False) if "next" in h
                                 else None),
                        "ref": (rows(h["ref"], True)
                                if h.get("ref") is not None
                                and h["ref"] is not h["after"] else None),
                        "bootstrap": h.get("bootstrap", False),
                        "solve": h.get("solve", False),
                        "expect_merge": expect[k], "last_merge_pose": last[k],
                        "stamp": run.stamps[k] * 1e-9})
    return {"samples": samples}


def free_program(run) -> None:
    """Drop the program's state before the reference runs, so that the
    reference neither shares the card with it nor sets the peak."""
    run.mapper.shutdown()
    for name in ("mapper", "batches", "held"):
        if hasattr(run, name):
            delattr(run, name)
    gc.collect()
    if run.on_card:
        torch.cuda.empty_cache()


def checks_line(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    return {name: {"value": values[name], "limit": limits[name]}
            for name in limits}


def emit(result: dict, checks: dict) -> None:
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    result["checks"] = checks  # the last key of the line
    print(json.dumps(result), flush=True)
