"""Builds the package's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``build/lib<name>-<hash>.so``: compiled by
``nvcc`` for ``sm_90a`` into a shared library with a plain C interface (no
PyTorch headers, so a build takes seconds).  The file name carries a hash of
every source under ``csrc/``, so an edit rebuilds.  ``build/`` is listed in
``.gitignore``.

Importing this module needs neither ``nvcc`` nor a card; only ``load`` does.
``start_builds`` launches one ``nvcc`` per source at once so that a program
using several kernels waits for the slowest build, not for their sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

__all__ = ["load", "start_builds", "KERNEL_SOURCES", "build_dir"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
KERNEL_SOURCES = ("sweep_knn", "radius_pca", "knn_brute", "sym_eig",
                  "graph_loop", "kabsch", "philox", "knn_grid")

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_procs: Dict[str, subprocess.Popen] = {}
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}  # name -> nvcc output (ptxas -v report)


def build_dir() -> Path:
    return _PKG / "build"


def _nvcc() -> str:
    exe = shutil.which("nvcc")
    if exe is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        exe = "/usr/local/cuda/bin/nvcc"
    if exe is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of norlab_icp_mapper_tpu_torch "
            "are compiled at first use and need the CUDA toolkit")
    return exe


def _sources_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(_CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    h.update(" ".join(_NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_sources_hash()}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start the build of one source unless its library already exists."""
    out = _lib_path(name)
    if out.exists() or name in _procs:
        return _procs.get(name)
    build_dir().mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp),
           str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc._nim_tmp = tmp  # type: ignore[attr-defined]
    _procs[name] = proc
    return proc


def start_builds(names=KERNEL_SOURCES) -> None:
    """Start building every named kernel in parallel (returns at once)."""
    with _lock:
        for name in names:
            _start(name)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed.
    A failed build raises with the compiler's output."""
    with _lock:
        if name in _libs:
            return _libs[name]
        out = _lib_path(name)
        proc = _start(name)
        if proc is not None:
            log, _ = proc.communicate()
            build_logs[name] = log
            del _procs[name]
            tmp = proc._nim_tmp  # type: ignore[attr-defined]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed building {name}.cu "
                    f"(exit {proc.returncode}):\n{log}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _libs[name] = lib
        return lib
