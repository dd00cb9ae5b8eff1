"""norlab_icp_mapper_tpu_torch -- the PyTorch/CUDA port of the JAX/TPU mapper.

A 2-D/3-D lidar ICP mapping framework: scan filtering, scan-to-map ICP
registration, conditional map merge through MapperModules, rolling-window
tiled map with cell eviction, and trajectory recording.  Plain tensor code is
PyTorch; the two kernels of the offline mapping path (the sorted-sweep radius
matcher and the radius-neighbourhood PCA) are CUDA C++ written by hand for
Hopper (``csrc/``), compiled with ``nvcc`` at first use.

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when there is no card; pass ``device="cpu"`` to run on the CPU, where
each kernel's plain PyTorch version takes its place.
"""

import torch as _torch

# Geometry pipelines are cancellation-sensitive (normal equations, pose
# composition, covariance from moments).  TF32 keeps about three decimal
# digits, which injects ~1e-3 relative error into 3x3/4x4 transform math and
# the 6x6 normal equations -- pin every float32 matrix product to full
# float32, whatever the process-wide default was.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

from .points import PointBatch, concatenate, bucket_capacity
from .draws import DrawSource
from .trajectory import Trajectory
from .cell_manager import CellManager, RAMCellManager, HardDriveCellManager
from .mapper import Mapper
from .map import Map
from .filters import FilterChain, filter_registry
from .mapper_modules import mapper_module_registry
from .icp.engine import ICPEngine, ICPResult
from . import se3, io, convert, slam, utils

__version__ = "0.1.0"

__all__ = [
    "PointBatch", "concatenate", "bucket_capacity", "DrawSource", "Trajectory",
    "CellManager", "RAMCellManager", "HardDriveCellManager", "Mapper", "Map",
    "FilterChain", "filter_registry", "mapper_module_registry", "ICPEngine",
    "ICPResult", "se3", "io", "convert", "slam", "utils",
]
