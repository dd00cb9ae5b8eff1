"""PCD (Point Cloud Data) IO — ascii and binary encodings.

Completes the loader surface libpointmatcher exposes for the mapper's
``DP::load``/``.save`` call sites (reference ``docs/RunningExample.md:25``
lists VTK/CSV/PLY/PCD). Fields named x, y, z become positions; other
fields become descriptors, with ``normal_x/y/z`` grouped into a single
``normals`` descriptor the way lpm does.  The port's own copy of the JAX
package's module (numpy only).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from .ply_csv import _group_descriptors

__all__ = ["read_pcd", "write_pcd"]

_PCD_DTYPES = {
    ("F", 4): np.float32, ("F", 8): np.float64,
    ("I", 1): np.int8, ("I", 2): np.int16, ("I", 4): np.int32,
    ("U", 1): np.uint8, ("U", 2): np.uint16, ("U", 4): np.uint32,
}


def read_pcd(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read an ascii or binary (uncompressed) PCD v0.7 file."""
    header: Dict[str, list] = {}
    with open(path, "rb") as f:
        while True:
            raw = f.readline()
            if not raw:
                raise ValueError(f"{path}: unexpected EOF in PCD header")
            line = raw.decode("ascii", errors="replace").strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            header[toks[0].upper()] = toks[1:]
            if toks[0].upper() == "DATA":
                break
        fields = header["FIELDS"]
        sizes = [int(s) for s in header["SIZE"]]
        types = header["TYPE"]
        counts = [int(c) for c in header.get("COUNT", ["1"] * len(fields))]
        n = int(header["POINTS"][0])
        encoding = header["DATA"][0].lower()

        names, dtypes = [], []
        for fld, sz, ty, cnt in zip(fields, sizes, types, counts):
            dt = _PCD_DTYPES.get((ty.upper(), sz))
            if dt is None:
                raise ValueError(f"{path}: unsupported PCD field type {ty}{sz}")
            for c in range(cnt):
                names.append(fld if cnt == 1 else f"{fld}_{c}")
                dtypes.append(dt)

        if n == 0:
            cols = [np.zeros((0,), np.float32) for _ in names]
        elif encoding == "ascii":
            data = np.loadtxt(f, dtype=np.float64, max_rows=n)
            data = np.atleast_2d(data)
            cols = [data[:, i].astype(np.float32) for i in range(len(names))]
        elif encoding == "binary":
            rec = np.dtype([(nm, dt) for nm, dt in zip(names, dtypes)])
            arr = np.frombuffer(f.read(rec.itemsize * n), dtype=rec, count=n)
            cols = [arr[nm].astype(np.float32) for nm in names]
        else:
            raise ValueError(
                f"{path}: unsupported PCD DATA encoding '{encoding}' "
                "(ascii and binary supported; binary_compressed is not)")

    by_name = {nm.lower(): c for nm, c in zip(names, cols)}
    dims = [c for c in ("x", "y", "z") if c in by_name]
    if not dims:
        raise ValueError(f"{path}: PCD file has no x/y/z fields")
    pos = np.stack([by_name[c] for c in dims], axis=1)
    keep = ~np.any(np.isnan(pos), axis=1)  # PCD pads unorganized gaps w/ NaN
    desc = _group_descriptors(names, cols)
    if not np.all(keep):
        pos = pos[keep]
        desc = {k: v[keep] for k, v in desc.items()}
    return pos, desc


def write_pcd(path: str, positions: np.ndarray,
              descriptors: Dict[str, np.ndarray] | None = None,
              binary: bool = False) -> None:
    positions = np.asarray(positions, np.float32)
    n, d = positions.shape
    names = list("xyz"[:d])
    cols = [positions[:, i] for i in range(d)]
    for name, v in (descriptors or {}).items():
        v = np.asarray(v, np.float32)
        if v.ndim == 1:
            v = v[:, None]
        if name == "normals":
            sub = ["normal_x", "normal_y", "normal_z"][: v.shape[1]]
        elif v.shape[1] == 1:
            sub = [name]
        else:
            sub = [f"{name}_{i}" for i in range(v.shape[1])]
        for i, nm in enumerate(sub):
            names.append(nm)
            cols.append(v[:, i])
    k = len(names)
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS {' '.join(names)}\n"
        f"SIZE {' '.join(['4'] * k)}\n"
        f"TYPE {' '.join(['F'] * k)}\n"
        f"COUNT {' '.join(['1'] * k)}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n")
    data = np.stack(cols, axis=1).astype(np.float32)
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        if binary:
            f.write(np.ascontiguousarray(data).tobytes())
        else:
            np.savetxt(f, data, fmt="%.7g")
