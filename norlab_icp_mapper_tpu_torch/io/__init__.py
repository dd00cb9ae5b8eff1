"""Point-cloud and trajectory file IO of the port (host code: numpy, and the
native VTK parser of ``native.py``), and the loader that uploads scans onto
the card ahead of the pipeline (``loader.py``)."""
from .vtk import read_vtk, write_vtk
from .trajectory_csv import read_trajectory_csv
from .ply_csv import read_ply, write_ply, read_csv_cloud, write_csv_cloud
from .pcd import read_pcd, write_pcd

__all__ = ["read_vtk", "write_vtk", "read_trajectory_csv",
           "read_ply", "write_ply", "read_csv_cloud", "write_csv_cloud",
           "read_pcd", "write_pcd",
           "read_point_cloud", "write_point_cloud"]

_READERS = {".vtk": read_vtk, ".ply": read_ply, ".csv": read_csv_cloud,
            ".pcd": read_pcd}
_WRITERS = {".vtk": write_vtk, ".ply": write_ply, ".csv": write_csv_cloud,
            ".pcd": write_pcd}


def _by_extension(table, path: str):
    for ext, fn in table.items():
        if path.lower().endswith(ext):
            return fn
    raise ValueError(f"unsupported point cloud format: {path}")


def read_point_cloud(path: str):
    """Format-dispatching loader (by extension), like lpm's ``DP::load``."""
    return _by_extension(_READERS, path)(path)


def write_point_cloud(path: str, positions, descriptors=None):
    return _by_extension(_WRITERS, path)(path, positions, descriptors)
