"""Offline batch mapping entry point of the port: scans and a trajectory from
files in, ``map.vtk`` and ``trajectory.vtk`` out.

    python -m norlab_icp_mapper_tpu_torch.build_map <dataPath> <configFilePath> [outputDir] [--device cuda|cpu]

``dataPath`` holds ``scans/*.{vtk,ply,csv,pcd}`` (sorted by name, matched
1:1 by order to the rows of ``icp_odom.csv``: no interpolation, reference
``docs/RunningExample.md:30-33``) and ``icp_odom.csv`` (ROS-PoseStamped
columns).  The outputs go to ``outputDir`` (default: ``dataPath``).  The
device defaults to the card and the run raises if there is none; ``--device
cpu`` runs on the CPU.

Scans come through :class:`~norlab_icp_mapper_tpu_torch.io.loader.ScanLoader`
(parsed on threads, uploaded on a side stream ahead of the pipeline) and go
through ``Mapper.apply_input_filters`` and ``Mapper.process_input`` without a
drain between them, as the reference example does
(``examples/build_map_from_scans_and_trajectory.cpp:218-235``).
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Optional, Union

import numpy as np
import torch

from .draws import resolve_device
from .io import read_trajectory_csv, write_vtk
from .io.loader import ScanLoader
from .mapper import Mapper

__all__ = ["main"]

SCAN_EXTENSIONS = (".vtk", ".ply", ".csv", ".pcd")


def main(data_path: str, config_path: str, out_dir: Optional[str] = None,
         verbose: bool = True,
         device: Union[str, torch.device, None] = None):
    """Build the map; returns ``(mapper, per_scan_seconds)``.  The seconds
    are host time per scan (the loop enqueues work on the card and waits
    only where the Mapper counts a wait); the total printed at the end
    includes the final ``drain()``."""
    dev = resolve_device(device)
    out_dir = out_dir or data_path
    os.makedirs(out_dir, exist_ok=True)
    scans_dir = os.path.join(data_path, "scans")
    scan_files = sorted(f for f in os.listdir(scans_dir)
                        if f.lower().endswith(SCAN_EXTENSIONS))
    poses = read_trajectory_csv(os.path.join(data_path, "icp_odom.csv"))
    if len(scan_files) != len(poses):
        raise ValueError(f"scan count {len(scan_files)} != trajectory rows "
                         f"{len(poses)}")

    # reference ctor args (examples/...cpp:218-220)
    mapper = Mapper(config_path, is_3d=True, is_online=False,
                    is_mapping=True, save_map_cells_on_hard_drive=False,
                    device=dev)
    # four scans ahead on two threads: a 49,152-point VTK file parses in
    # about a step, a text file (PLY, CSV) in two or three; more threads
    # only contend with this loop for the interpreter lock
    loader = ScanLoader([os.path.join(scans_dir, f) for f in scan_files],
                        extras=poses, prefetch=4, workers=2, device=dev)
    per_scan = []
    try:
        t_start = time.perf_counter()
        for i, (scan, n_valid, (pose, stamp_ns)) in enumerate(loader):
            t0 = time.perf_counter()
            filtered = mapper.apply_input_filters(scan)
            mapper.process_input(filtered, pose, stamp_ns,
                                 scan_valid_hint=n_valid)
            per_scan.append(time.perf_counter() - t0)
            if verbose:
                print(f"{scan_files[i]}: {per_scan[-1] * 1e3:.1f} ms",
                      flush=True)
        mapper.drain()  # the total includes the card's queued work
        total = time.perf_counter() - t_start
    finally:
        loader.close()

    cloud = mapper.get_map()
    write_vtk(os.path.join(out_dir, "map.vtk"), cloud["positions"],
              {k: v for k, v in cloud.items() if k != "positions"})
    mapper.get_trajectory().save(os.path.join(out_dir, "trajectory.vtk"))
    if verbose:
        n = len(scan_files)
        print(f"\n{n} scans in {total:.2f} s ({n / total:.2f} scans/s; "
              f"median {np.median(per_scan) * 1e3:.1f} ms/scan)")
        print(f"map points: {cloud['positions'].shape[0]}")
    mapper.shutdown()
    return mapper, per_scan


def _parse(argv):
    ap = argparse.ArgumentParser(
        prog="python -m norlab_icp_mapper_tpu_torch.build_map",
        description="Build a map from scans and a trajectory CSV.")
    ap.add_argument("data_path")
    ap.add_argument("config_path")
    ap.add_argument("out_dir", nargs="?", default=None)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


if __name__ == "__main__":
    args = _parse(sys.argv[1:])
    main(args.data_path, args.config_path, args.out_dir, device=args.device)
