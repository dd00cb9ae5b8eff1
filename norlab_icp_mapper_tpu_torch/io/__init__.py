"""Point-cloud file IO of the port: the legacy-VTK reader and writer that the
cell manager and the trajectory need (numpy only)."""
from .vtk import read_vtk, write_vtk

__all__ = ["read_vtk", "write_vtk"]
