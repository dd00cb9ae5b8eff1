"""Cell storage backends for evicted map cells.

Parity with reference ``CellManager.h`` (ABC: ``getAllCellIds``, ``saveCell``,
``retrieveCell``, ``clearAllCells``), ``RAMCellManager`` (in-memory
unordered_map) and ``HardDriveCellManager`` (``/tmp/cell_<id>.vtk`` spill
files deleted on destruction — a spill store, not a durable checkpoint,
``HardDriveCellManager.cpp:4-7``).

Cells are host-side dicts of numpy arrays (``positions`` + descriptors), the
compact form produced by ``PointBatch.to_numpy()`` — eviction is the
device-to-host spill path of the rolling-window map, so cells never hold
device memory.  Numpy only: no tensor reaches this module.
"""
from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional

import numpy as np

from .io.vtk import read_vtk, write_vtk

__all__ = ["CellManager", "RAMCellManager", "HardDriveCellManager"]

Cell = Dict[str, np.ndarray]  # 'positions' [n, D] + descriptor arrays


class CellManager:
    def get_all_cell_ids(self) -> List[str]:
        raise NotImplementedError

    def save_cell(self, cell_id: str, cell: Cell) -> None:
        raise NotImplementedError

    def retrieve_cell(self, cell_id: str) -> Optional[Cell]:
        raise NotImplementedError

    def remove_cell(self, cell_id: str) -> None:
        """Delete one saved cell (sharded restore path: a retrieved cell is
        re-inserted device-side and must leave the store so a point is never
        both device-resident and spilled).  Not in the reference ABC —
        the reference tracks ``loadedCellIds`` instead (``Map.cpp:105``)."""
        raise NotImplementedError

    def clear_all_cells(self) -> None:
        raise NotImplementedError


class RAMCellManager(CellManager):
    """In-memory store (reference ``RAMCellManager.h:12``)."""

    def __init__(self):
        self._cells: Dict[str, Cell] = {}

    def get_all_cell_ids(self) -> List[str]:
        return list(self._cells)

    def save_cell(self, cell_id: str, cell: Cell) -> None:
        self._cells[cell_id] = cell

    def retrieve_cell(self, cell_id: str) -> Optional[Cell]:
        return self._cells.get(cell_id)

    def remove_cell(self, cell_id: str) -> None:
        self._cells.pop(cell_id, None)

    def clear_all_cells(self) -> None:
        self._cells = {}


class HardDriveCellManager(CellManager):
    """Disk spill store: one VTK file per cell (reference
    ``HardDriveCellManager.h:12-14``); files removed on clear/destruction."""

    PREFIX = "cell_"
    SUFFIX = ".vtk"

    def __init__(self, directory: Optional[str] = None):
        self._dir = directory or tempfile.mkdtemp(prefix="nim_torch_cells_")
        os.makedirs(self._dir, exist_ok=True)
        self._ids: set = set()

    def _path(self, cell_id: str) -> str:
        return os.path.join(self._dir, f"{self.PREFIX}{cell_id}{self.SUFFIX}")

    def get_all_cell_ids(self) -> List[str]:
        return list(self._ids)

    def save_cell(self, cell_id: str, cell: Cell) -> None:
        desc = {k: v for k, v in cell.items() if k != "positions"}
        write_vtk(self._path(cell_id), cell["positions"], desc)
        self._ids.add(cell_id)

    def retrieve_cell(self, cell_id: str) -> Optional[Cell]:
        if cell_id not in self._ids:
            return None
        pos, desc = read_vtk(self._path(cell_id))
        out: Cell = {"positions": pos}
        out.update(desc)
        return out

    def remove_cell(self, cell_id: str) -> None:
        if cell_id in self._ids:
            self._ids.discard(cell_id)
            try:
                os.remove(self._path(cell_id))
            except OSError:
                pass

    def clear_all_cells(self) -> None:
        for cid in list(self._ids):
            try:
                os.remove(self._path(cid))
            except OSError:
                pass
        self._ids = set()

    def __del__(self):
        try:
            self.clear_all_cells()
            os.rmdir(self._dir)
        except Exception:
            pass
