"""ctypes bridge to the native C++ VTK reader/writer (``csrc/vtk_fast.cpp``).

Host IO, not a device kernel.  The shared library is built on demand with
``g++`` into the package's ``build/`` directory (git-ignored), under a name
that carries a hash of the source, so an edit rebuilds; the build writes a
temporary file and renames it, so processes that build at once do not read
a half-written library.  If ``g++`` or the build is missing, or
``NIM_TPU_DISABLE_NATIVE`` is set (the switch the JAX package reads too),
every entry point returns ``None`` / ``False`` and the callers in
``vtk.py`` use the numpy parser.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np

__all__ = ["read_vtk_native", "write_vtk_native", "library_path"]

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "vtk_fast.cpp"
_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the library of the current source is (or will be) built."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode())
    return _PKG / "build" / f"libvtk_fast-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        if os.environ.get("NIM_TPU_DISABLE_NATIVE"):
            return None
        try:
            out = library_path()
            if not out.exists():
                _build(out)
            lib = ctypes.CDLL(str(out))
        except (OSError, subprocess.SubprocessError):
            return None  # no g++, a failed build, or an unloadable library
        lib.vtk_open.restype = ctypes.c_void_p
        lib.vtk_open.argtypes = [ctypes.c_char_p]
        lib.vtk_error.restype = ctypes.c_char_p
        lib.vtk_error.argtypes = [ctypes.c_void_p]
        lib.vtk_num_points.restype = ctypes.c_int
        lib.vtk_num_points.argtypes = [ctypes.c_void_p]
        lib.vtk_num_fields.restype = ctypes.c_int
        lib.vtk_num_fields.argtypes = [ctypes.c_void_p]
        lib.vtk_field_name.restype = ctypes.c_char_p
        lib.vtk_field_name.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vtk_field_dim.restype = ctypes.c_int
        lib.vtk_field_dim.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.vtk_get_positions.restype = None
        lib.vtk_get_positions.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.vtk_get_field.restype = None
        lib.vtk_get_field.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_void_p]
        lib.vtk_close.restype = None
        lib.vtk_close.argtypes = [ctypes.c_void_p]
        lib.vtk_write.restype = ctypes.c_int
        lib.vtk_write.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_void_p)]
        _lib = lib
        return _lib


def read_vtk_native(path: str) -> Optional[
        Tuple[np.ndarray, Dict[str, np.ndarray]]]:
    """``(positions f32[n, 3], {name: f32[n, k]})``, or ``None`` when the
    library is unavailable or the file is not one it reads (the numpy
    parser then reads it and reports any error)."""
    lib = _load()
    if lib is None:
        return None
    h = lib.vtk_open(path.encode())
    try:
        if lib.vtk_error(h):
            return None
        n = lib.vtk_num_points(h)
        pos = np.empty((n, 3), np.float32)
        lib.vtk_get_positions(h, pos.ctypes.data_as(ctypes.c_void_p))
        desc: Dict[str, np.ndarray] = {}
        for i in range(lib.vtk_num_fields(h)):
            name = lib.vtk_field_name(h, i).decode()
            arr = np.empty((n, lib.vtk_field_dim(h, i)), np.float32)
            lib.vtk_get_field(h, i, arr.ctypes.data_as(ctypes.c_void_p))
            desc[name] = arr
        return pos, desc
    finally:
        lib.vtk_close(h)


def write_vtk_native(path: str, positions: np.ndarray,
                     descriptors: Optional[Dict[str, np.ndarray]] = None
                     ) -> bool:
    """Write float32 sections only; ``False`` when the library is
    unavailable or the write failed (the caller then writes with numpy)."""
    lib = _load()
    if lib is None:
        return False
    pos = np.ascontiguousarray(positions, np.float32)
    n = pos.shape[0]
    if pos.shape[1] == 2:  # 2-D clouds save with z = 0
        pos = np.ascontiguousarray(
            np.concatenate([pos, np.zeros((n, 1), np.float32)], axis=1))
    names, arrays = [], []
    for name, v in (descriptors or {}).items():
        v = np.ascontiguousarray(np.asarray(v, np.float32))
        if v.ndim == 1:
            v = v[:, None]
        names.append(name)
        arrays.append(v)
    nf = len(names)
    c_names = (ctypes.c_char_p * nf)(*[s.encode() for s in names])
    c_dims = (ctypes.c_int * nf)(*[a.shape[1] for a in arrays])
    c_ptrs = (ctypes.c_void_p * nf)(
        *[a.ctypes.data_as(ctypes.c_void_p) for a in arrays])
    rc = lib.vtk_write(path.encode(), n,
                       pos.ctypes.data_as(ctypes.c_void_p), nf,
                       c_names, c_dims, c_ptrs)
    return rc == 0
