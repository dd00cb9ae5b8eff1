from .nn_sweep import sweep_knn, sweep_knn_plain, presort_ref, presort_queries
from .pca import radius_pca, radius_pca_plain
from .voxel import voxel_coords, voxel_select

__all__ = ["sweep_knn", "sweep_knn_plain", "presort_ref", "presort_queries",
           "radius_pca", "radius_pca_plain", "voxel_coords", "voxel_select"]
