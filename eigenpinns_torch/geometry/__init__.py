"""Geometry: mesh IO, FEM assembly (host and device), the point-cloud
and mesh Laplacians, heat-method geodesics and point projection."""

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
from eigenpinns_torch.geometry.geodesics import (
    geodesic_ground_truth,
    heat_geodesics,
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
from eigenpinns_torch.geometry.projection import (
    project_points,
    project_points_device,
)

__all__ = ["TriMesh", "load_mesh", "load_obj", "normalize_mesh", "save_obj",
           "triangle_geometry", "element_stiffness", "element_mass",
           "assemble_coo", "assemble_stiffness_mass", "element_force",
           "assemble_force", "gradient_operator", "mesh_laplacian",
           "point_cloud_laplacian", "heat_geodesics",
           "geodesic_ground_truth", "project_points",
           "project_points_device"]
