"""Host-side geometry (numpy/scipy): mesh IO and the point-cloud
Laplacian."""

from eigenpinns_torch.geometry.mesh import (
    TriMesh,
    load_mesh,
    load_obj,
    normalize_mesh,
)
from eigenpinns_torch.geometry.point_cloud import point_cloud_laplacian

__all__ = ["TriMesh", "load_mesh", "load_obj", "normalize_mesh",
           "point_cloud_laplacian"]
