from .nn import knn, knn_plain, nn1, radius_knn, pack_refs
from .nn_sweep import sweep_knn, sweep_knn_plain, presort_ref, presort_queries
from .pca import (radius_pca, radius_pca_plain, radius_pca_normals,
                  radius_pca_normals_plain)
from .voxel import voxel_coords, voxel_select

__all__ = ["knn", "knn_plain", "nn1", "radius_knn", "pack_refs",
           "sweep_knn", "sweep_knn_plain", "presort_ref", "presort_queries",
           "radius_pca", "radius_pca_plain", "radius_pca_normals",
           "radius_pca_normals_plain", "voxel_coords", "voxel_select"]
