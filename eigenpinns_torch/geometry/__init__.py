"""Geometry: mesh IO, FEM assembly (host and device) and the point-cloud
and mesh Laplacians."""

from eigenpinns_torch.geometry.fem import (
    assemble_coo,
    assemble_force,
    assemble_stiffness_mass,
    element_force,
    element_mass,
    element_stiffness,
    gradient_operator,
    triangle_geometry,
)
from eigenpinns_torch.geometry.mesh import (
    TriMesh,
    load_mesh,
    load_obj,
    normalize_mesh,
    save_obj,
)
from eigenpinns_torch.geometry.point_cloud import (
    mesh_laplacian,
    point_cloud_laplacian,
)

__all__ = ["TriMesh", "load_mesh", "load_obj", "normalize_mesh", "save_obj",
           "triangle_geometry", "element_stiffness", "element_mass",
           "assemble_coo", "assemble_stiffness_mass", "element_force",
           "assemble_force", "gradient_operator", "mesh_laplacian",
           "point_cloud_laplacian"]
