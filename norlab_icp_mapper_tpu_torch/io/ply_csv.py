"""ASCII PLY and CSV point-cloud IO.

libpointmatcher's loader also accepts PLY/CSV/PCD next to VTK
(reference ``docs/RunningExample.md:25``); these cover the ASCII PLY and
CSV forms. Columns named x, y, z become positions; any other numeric
property/column becomes a descriptor (grouping ``nx, ny, nz`` into
``normals`` like lpm does).  The port's own copy of the JAX package's
module (numpy only): both packages decode a file to the same arrays.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

__all__ = ["read_ply", "write_ply", "read_csv_cloud", "write_csv_cloud"]

_NORMAL_ALIASES = {"nx": 0, "ny": 1, "nz": 2,
                   "normal_x": 0, "normal_y": 1, "normal_z": 2}


def _group_descriptors(names, cols):
    desc: Dict[str, np.ndarray] = {}
    normals = {}
    for name, col in zip(names, cols):
        low = name.lower()
        if low in ("x", "y", "z"):
            continue
        if low in _NORMAL_ALIASES:
            normals[_NORMAL_ALIASES[low]] = col
        else:
            desc[name] = col[:, None]
    if len(normals) == 3:
        desc["normals"] = np.stack([normals[i] for i in range(3)], axis=1)
    return desc


def read_ply(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read an ASCII PLY file with a vertex element."""
    with open(path, "r") as f:
        line = f.readline().strip()
        if line != "ply":
            raise ValueError(f"{path}: not a PLY file")
        n_vertex = 0
        props = []
        fmt = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            toks = line.split()
            if not toks:
                continue
            if toks[0] == "format":
                fmt = toks[1]
            elif toks[0] == "element":
                in_vertex = toks[1] == "vertex"
                if in_vertex:
                    n_vertex = int(toks[2])
            elif toks[0] == "property" and in_vertex:
                props.append(toks[-1])
            elif toks[0] == "end_header":
                break
        if fmt != "ascii":
            raise ValueError(f"{path}: only ASCII PLY supported (got {fmt})")
        data = np.loadtxt(f, dtype=np.float64, max_rows=n_vertex)
    data = np.atleast_2d(data).astype(np.float32)
    cols = {p: data[:, i] for i, p in enumerate(props)}
    dims = [c for c in ("x", "y", "z") if c in cols]
    pos = np.stack([cols[c] for c in dims], axis=1)
    desc = _group_descriptors(props, [data[:, i] for i in range(len(props))])
    return pos, desc


def write_ply(path: str, positions: np.ndarray,
              descriptors: Dict[str, np.ndarray] | None = None) -> None:
    positions = np.asarray(positions, np.float32)
    n, d = positions.shape
    desc = dict(descriptors or {})
    cols = [positions[:, i] for i in range(d)]
    names = list("xyz"[:d])
    if "normals" in desc:
        nrm = np.asarray(desc.pop("normals"), np.float32)
        for i, nm in enumerate(("nx", "ny", "nz")[: nrm.shape[1]]):
            names.append(nm)
            cols.append(nrm[:, i])
    for name, v in desc.items():
        v = np.asarray(v, np.float32)
        if v.ndim == 1:
            v = v[:, None]
        for i in range(v.shape[1]):
            names.append(name if v.shape[1] == 1 else f"{name}_{i}")
            cols.append(v[:, i])
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write("comment created by norlab_icp_mapper_tpu_torch\n")
        f.write(f"element vertex {n}\n")
        for nm in names:
            f.write(f"property float {nm}\n")
        f.write("end_header\n")
        np.savetxt(f, np.stack(cols, axis=1), fmt="%.7g")


def read_csv_cloud(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read a CSV point cloud with a header row naming the columns."""
    with open(path, "r") as f:
        header = f.readline().strip()
        sep = "," if "," in header else None
        names = [h.strip() for h in (header.split(",") if sep else header.split())]
        data = np.loadtxt(f, delimiter=sep, dtype=np.float64)
    data = np.atleast_2d(data).astype(np.float32)
    cols = {nm.lower(): data[:, i] for i, nm in enumerate(names)}
    dims = [c for c in ("x", "y", "z") if c in cols]
    pos = np.stack([cols[c] for c in dims], axis=1)
    desc = _group_descriptors(names, [data[:, i] for i in range(len(names))])
    return pos, desc


def write_csv_cloud(path: str, positions: np.ndarray,
                    descriptors: Dict[str, np.ndarray] | None = None) -> None:
    positions = np.asarray(positions, np.float32)
    n, d = positions.shape
    names = list("xyz"[:d])
    cols = [positions[:, i] for i in range(d)]
    for name, v in (descriptors or {}).items():
        v = np.asarray(v, np.float32)
        if v.ndim == 1:
            v = v[:, None]
        if name == "normals":
            sub = ["nx", "ny", "nz"][: v.shape[1]]
        elif v.shape[1] == 1:
            sub = [name]
        else:
            sub = [f"{name}_{i}" for i in range(v.shape[1])]
        for i, nm in enumerate(sub):
            names.append(nm)
            cols.append(v[:, i])
    with open(path, "w") as f:
        f.write(",".join(names) + "\n")
        np.savetxt(f, np.stack(cols, axis=1), fmt="%.7g", delimiter=",")
