"""Faults planted in the program underneath a run, for the checks that
``correct`` catches them (``tests/test_port_bench_correct.py`` on the CPU,
``control.py --fault`` on the card).  Each is ``(module, class,
attribute, wrap)``: ``wrap(real)`` returns the broken attribute."""
from __future__ import annotations

import importlib

import torch


def _identity_solve(real):
    def solve(self, *a, **k):
        out = real(self, *a, **k)
        eye = torch.eye(4, dtype=out[0].dtype, device=out[0].device)
        return out._replace(correction=eye)
    return solve


def _unchanged_merge(real):
    def merge(self, bufs, aux):
        return dict(bufs), bufs["map"].count()
    return merge


def _half_merge(real):
    def merge_bufs(self, bufs, scan_m, correction, corrected):
        half = scan_m.mask.clone()
        half[half.shape[0] // 2:] = False
        return real(self, bufs, scan_m.with_mask(half), correction,
                    corrected)
    return merge_bufs


def _altered_pose(real):
    def register(self, bufs, meta, scan, est_pose, stamp_s, is_mapping):
        new_meta, aux = real(self, bufs, meta, scan, est_pose, stamp_s,
                             is_mapping)
        shift = torch.zeros_like(new_meta["pose"])
        shift[0, 3] = 0.05
        return dict(new_meta, pose=new_meta["pose"] + shift), aux
    return register


FAULTS = {
    "solve_returns_its_state": ("icp.engine", "ICPEngine", "solve",
                                _identity_solve),
    "merge_returns_its_state": ("fused", "FusedScanStep", "merge",
                                _unchanged_merge),
    "half_the_scan_left_out": ("fused", "FusedScanStep", "_merge_bufs",
                               _half_merge),
    "pose_altered_where_produced": ("fused", "FusedScanStep", "register",
                                    _altered_pose),
}


def plant(name: str, setattr_=setattr):
    """Breaks the program as fault ``name`` says (``setattr_`` lets a test
    undo it, e.g. ``monkeypatch.setattr``)."""
    module, cls, attr, wrap = FAULTS[name]
    owner = getattr(importlib.import_module(
        f"norlab_icp_mapper_tpu_torch.{module}"), cls)
    setattr_(owner, attr, wrap(getattr(owner, attr)))
