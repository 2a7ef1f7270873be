from eigenpinns_torch.sampling.hierarchy import Hierarchy, build_hierarchy
from eigenpinns_torch.sampling.knn import knn_graph, prolongation_matrix
from eigenpinns_torch.sampling.samplers import (
    farthest_point_indices,
    farthest_point_levels,
)

__all__ = ["Hierarchy", "build_hierarchy", "knn_graph",
           "prolongation_matrix", "farthest_point_indices",
           "farthest_point_levels"]
