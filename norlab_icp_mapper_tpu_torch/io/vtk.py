"""Legacy-ASCII VTK POLYDATA point-cloud IO.

Replaces the libpointmatcher ``DataPoints::load``/``save`` path used by the
reference (``examples/build_map_from_scans_and_trajectory.cpp:228,235``,
``HardDriveCellManager.cpp:16,25``, ``Trajectory.cpp:52``).  Supports the
subset of the legacy VTK format lpm emits for the bundled example data:

  POINTS n float                      -> positions [n, 3]
  VERTICES n 2n                       -> ignored on read, emitted on write
  POINT_DATA n
    SCALARS <name> <type> [numComp]   -> descriptor [n, numComp]
    LOOKUP_TABLE default              -> skipped
    VECTORS <name> <type>             -> descriptor [n, 3]
    NORMALS <name> <type>             -> descriptor "normals" [n, 3]
    COLOR_SCALARS <name> <k>          -> descriptor [n, k]
    FIELD <name> <k>                  -> k named arrays

Parsing is numpy-vectorized (np.fromstring over the relevant text span) so a
41k-point scan loads in milliseconds, not seconds.

Both ASCII and BINARY legacy encodings are read (lpm's IO accepts either —
``docs/RunningExample.md:25``); writes are ASCII.  Sections typed ``double``
keep float64 on read (everything else converts to float32) so exact payloads
like the trajectory's split time channel round-trip losslessly.
"""
from __future__ import annotations

import io as _io
from typing import Dict, Tuple

import numpy as np

__all__ = ["read_vtk", "write_vtk"]

# legacy-VTK type name -> big-endian numpy dtype (binary payloads are
# big-endian per the VTK legacy spec)
_VTK_DTYPES = {
    "bit": ">u1", "unsigned_char": ">u1", "char": ">i1",
    "unsigned_short": ">u2", "short": ">i2",
    "unsigned_int": ">u4", "int": ">i4",
    "unsigned_long": ">u8", "long": ">i8",
    "float": ">f4", "double": ">f8", "vtktypeint64": ">i8",
    "vtktypeuint64": ">u8",
}


_COMMENT = "File created by norlab_icp_mapper_tpu_torch"


def _out_dtype(vtk_type: str):
    """Sections declared ``double`` keep f64; all else narrows to f32."""
    return np.float64 if vtk_type == "double" else np.float32


def _parse_block(lines, start, n_values):
    """Parse whitespace-separated floats from lines[start:] until n_values
    consumed. Returns (array, next_line_index).

    Fast path: VTK writers emit a fixed number of values per line, so the
    line span is computable and the whole section parses with ONE
    ``np.fromstring`` over the joined text (~10x faster than per-line)."""
    # find first non-empty line and its value count
    i = start
    while i < len(lines) and not lines[i].split():
        i += 1
    if i >= len(lines):
        raise ValueError(f"VTK parse error: expected {n_values} values, got 0")
    per_line = len(lines[i].split())
    n_lines = -(-n_values // per_line)
    chunk = "\n".join(lines[i:i + n_lines])
    arr = np.fromstring(chunk, dtype=np.float64, sep=" ")
    if arr.size >= n_values:
        return arr[:n_values], i + n_lines
    # ragged line lengths: fall back to per-line accumulation
    vals = []
    need = n_values
    while need > 0 and i < len(lines):
        row = np.fromstring(lines[i], dtype=np.float64, sep=" ")
        if row.size == 0:
            i += 1
            continue
        vals.append(row)
        need -= row.size
        i += 1
    arr = np.concatenate(vals) if vals else np.zeros((0,))
    if arr.size < n_values:
        raise ValueError(f"VTK parse error: expected {n_values} values, got {arr.size}")
    return arr[:n_values], i


def _read_vtk_binary(data: bytes) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Parse a legacy BINARY VTK file (big-endian payloads per the spec)."""
    pos = 0

    def next_line() -> str:
        nonlocal pos
        nl = data.find(b"\n", pos)
        if nl < 0:
            line, pos2 = data[pos:], len(data)
        else:
            line, pos2 = data[pos:nl], nl + 1
        pos = pos2
        return line.decode("ascii", errors="replace").strip()

    def take(vtk_type: str, count: int) -> np.ndarray:
        nonlocal pos
        dt = np.dtype(_VTK_DTYPES[vtk_type])
        arr = np.frombuffer(data, dtype=dt, count=count, offset=pos)
        if arr.size < count:
            raise ValueError(
                f"VTK binary parse error: expected {count} x {vtk_type}")
        pos += dt.itemsize * count
        if data[pos:pos + 1] == b"\n":  # sections end with one newline
            pos += 1
        return arr

    n_points = 0
    n_data = 0
    positions = None
    descriptors: Dict[str, np.ndarray] = {}
    while pos < len(data):
        toks = next_line().split()
        if not toks:
            continue
        key = toks[0].upper()
        if key == "POINTS":
            n_points = int(toks[1])
            flat = take(toks[2].lower(), n_points * 3)
            positions = flat.reshape(n_points, 3).astype(np.float32)
        elif key in ("VERTICES", "LINES", "POLYGONS", "TRIANGLE_STRIPS"):
            take("int", int(toks[2]))
        elif key == "POINT_DATA":
            n_data = int(toks[1])
        elif key == "SCALARS":
            vtype = toks[2].lower()
            ncomp = int(toks[3]) if len(toks) > 3 else 1
            lut = next_line()  # LOOKUP_TABLE line (required by the spec)
            if not lut.upper().startswith("LOOKUP_TABLE"):
                raise ValueError("VTK binary parse error: missing LOOKUP_TABLE")
            flat = take(vtype, n_data * ncomp)
            descriptors[toks[1]] = flat.reshape(n_data, ncomp).astype(
                _out_dtype(vtype))
        elif key in ("VECTORS", "NORMALS"):
            name = toks[1] if key == "VECTORS" else "normals"
            vtype = toks[2].lower()
            flat = take(vtype, n_data * 3)
            descriptors[name] = flat.reshape(n_data, 3).astype(_out_dtype(vtype))
        elif key == "COLOR_SCALARS":
            # binary color scalars are unsigned char in [0, 255] (VTK spec)
            ncomp = int(toks[2])
            flat = take("unsigned_char", n_data * ncomp)
            descriptors[toks[1]] = flat.reshape(n_data, ncomp).astype(np.float32)
        elif key == "FIELD":
            for _ in range(int(toks[2])):
                ftoks = next_line().split()
                while not ftoks:
                    ftoks = next_line().split()
                fname, fncomp, fcount = ftoks[0], int(ftoks[1]), int(ftoks[2])
                ftype = ftoks[3].lower() if len(ftoks) > 3 else "float"
                flat = take(ftype, fncomp * fcount)
                descriptors[fname] = flat.reshape(fcount, fncomp).astype(
                    _out_dtype(ftype))
    if positions is None:
        raise ValueError("no POINTS section in binary VTK data")
    return positions, descriptors


def read_vtk(path: str) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """Read a legacy VTK POLYDATA/UNSTRUCTURED file, ASCII or BINARY.

    Returns ``(positions [n,3] float32, descriptors {name: [n,k]})``.
    Descriptors typed ``double`` in the file stay float64; the rest are
    float32.  Plain-ASCII float32 files go through the native parser
    (``native.py``) when it is available; this numpy implementation reads
    the rest (binary files, ``double`` sections) and is its oracle.
    """
    with open(path, "rb") as f:
        raw = f.read()
    if b"double" not in raw:  # the native reader is float32-only
        from .native import read_vtk_native
        native = read_vtk_native(path)
        if native is not None:
            return native
    head = raw[:512].upper()
    if b"BINARY" in head.split(b"DATASET", 1)[0]:
        return _read_vtk_binary(raw)
    text = raw.decode("ascii", errors="replace")
    lines = text.splitlines()
    n_points = 0
    positions = None
    descriptors: Dict[str, np.ndarray] = {}
    i = 0
    n_data = 0
    while i < len(lines):
        line = lines[i].strip()
        toks = line.split()
        if not toks:
            i += 1
            continue
        key = toks[0].upper()
        if key == "POINTS":
            n_points = int(toks[1])
            flat, i = _parse_block(lines, i + 1, n_points * 3)
            positions = flat.reshape(n_points, 3).astype(np.float32)
            continue
        if key in ("VERTICES", "LINES", "POLYGONS", "TRIANGLE_STRIPS"):
            # connectivity: toks = [kind, n, total_ints]; skip total_ints ints
            total = int(toks[2])
            _, i = _parse_block(lines, i + 1, total)
            continue
        if key == "POINT_DATA":
            n_data = int(toks[1])
            i += 1
            continue
        if key == "SCALARS":
            name = toks[1]
            ncomp = int(toks[3]) if len(toks) > 3 else 1
            j = i + 1
            if j < len(lines) and lines[j].strip().upper().startswith("LOOKUP_TABLE"):
                j += 1
            flat, i = _parse_block(lines, j, n_data * ncomp)
            descriptors[name] = flat.reshape(n_data, ncomp).astype(
                _out_dtype(toks[2].lower()))
            continue
        if key in ("VECTORS", "NORMALS"):
            name = toks[1] if key == "VECTORS" else "normals"
            flat, i = _parse_block(lines, i + 1, n_data * 3)
            descriptors[name] = flat.reshape(n_data, 3).astype(
                _out_dtype(toks[2].lower() if len(toks) > 2 else "float"))
            continue
        if key == "COLOR_SCALARS":
            name = toks[1]
            ncomp = int(toks[2])
            flat, i = _parse_block(lines, i + 1, n_data * ncomp)
            descriptors[name] = flat.reshape(n_data, ncomp).astype(np.float32)
            continue
        if key == "FIELD":
            n_arrays = int(toks[2])
            i += 1
            for _ in range(n_arrays):
                while not lines[i].strip():
                    i += 1
                ftoks = lines[i].split()
                fname, fncomp, fcount = ftoks[0], int(ftoks[1]), int(ftoks[2])
                ftype = ftoks[3].lower() if len(ftoks) > 3 else "float"
                flat, i = _parse_block(lines, i + 1, fncomp * fcount)
                descriptors[fname] = flat.reshape(fcount, fncomp).astype(
                    _out_dtype(ftype))
            continue
        i += 1
    if positions is None:
        raise ValueError(f"no POINTS section in {path}")
    return positions, descriptors


def write_vtk(path: str, positions: np.ndarray,
              descriptors: Dict[str, np.ndarray] | None = None,
              comment: str = _COMMENT) -> None:
    """Write a legacy ASCII VTK POLYDATA file readable by ParaView and
    libpointmatcher (mirrors the layout of the reference's saved maps).

    Descriptors with float64 dtype are written as ``double`` sections and
    round-trip exactly (used by the trajectory's split time channel)."""
    desc_in = descriptors or {}
    has_f64 = any(np.asarray(v).dtype == np.float64 for v in desc_in.values())
    if not has_f64 and comment == _COMMENT:
        # the native writer emits float32 sections and this comment only
        from .native import write_vtk_native
        if write_vtk_native(path, positions, descriptors):
            return
    positions = np.asarray(positions, dtype=np.float32)
    n = positions.shape[0]
    if positions.shape[1] == 2:  # 2-D clouds save with z=0
        positions = np.concatenate(
            [positions, np.zeros((n, 1), np.float32)], axis=1)
    buf = _io.StringIO()
    buf.write("# vtk DataFile Version 3.0\n")
    buf.write(comment + "\n")
    buf.write("ASCII\nDATASET POLYDATA\n")
    buf.write(f"POINTS {n} float\n")
    np.savetxt(buf, positions, fmt="%.7g")
    buf.write(f"VERTICES {n} {2 * n}\n")
    verts = np.column_stack([np.ones(n, dtype=np.int64), np.arange(n, dtype=np.int64)])
    np.savetxt(buf, verts, fmt="%d")
    desc = desc_in
    if desc:
        buf.write(f"POINT_DATA {n}\n")
        for name, v in desc.items():
            v = np.asarray(v)
            f64 = v.dtype == np.float64
            v = v.astype(np.float64 if f64 else np.float32)
            vtype = "double" if f64 else "float"
            fmt = "%.17g" if f64 else "%.7g"
            if v.ndim == 1:
                v = v[:, None]
            k = v.shape[1]
            if name == "normals" and k == 3:
                buf.write(f"NORMALS {name} {vtype}\n")
                np.savetxt(buf, v, fmt=fmt)
            elif k == 3:
                buf.write(f"VECTORS {name} {vtype}\n")
                np.savetxt(buf, v, fmt=fmt)
            else:
                buf.write(f"SCALARS {name} {vtype} {k}\n")
                buf.write("LOOKUP_TABLE default\n")
                np.savetxt(buf, v, fmt=fmt)
    with open(path, "w") as f:
        f.write(buf.getvalue())
