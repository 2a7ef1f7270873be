from eigenpinns_torch.sampling.decimation import decimate, decimation_levels
from eigenpinns_torch.sampling.hierarchy import (
    COARSE_SOLVERS,
    EDGE_TYPES,
    SAMPLER_TYPES,
    Hierarchy,
    build_hierarchy,
)
from eigenpinns_torch.sampling.knn import (
    knn_graph,
    knn_graph_device,
    prolongation_matrix,
)
from eigenpinns_torch.sampling.samplers import (
    farthest_point_indices,
    farthest_point_levels,
    fps_device,
    leverage_score_levels,
    random_levels,
    voxel_levels,
)

__all__ = ["Hierarchy", "build_hierarchy", "SAMPLER_TYPES", "EDGE_TYPES",
           "COARSE_SOLVERS", "decimate", "decimation_levels", "knn_graph",
           "knn_graph_device", "fps_device",
           "prolongation_matrix", "farthest_point_indices",
           "farthest_point_levels", "voxel_levels", "random_levels",
           "leverage_score_levels"]
