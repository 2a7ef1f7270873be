"""Heat-method geodesic distances on triangle meshes.

Parity with `Mesh.computeGeodesic` (src/Mesh.py:239-305), which implements
Crane-Weischedel-Wardetzky's heat method:

  1. diffuse a source indicator: solve (M + dt K) u = u0;
  2. normalize the per-element surface gradient field X = -grad u / |grad u|;
  3. recover distances from the Poisson solve K phi = div X.

Also serves as the framework's ground-truth geodesic generator for the
eikonal Delta-PINN app, replacing the reference's `igl.exact_geodesic` C++
dependency (Laplace-PINN-coil.ipynb cell 9; SURVEY.md sec 2.3).

Host-side scipy solves (sparse Cholesky-grade problems, offline); the
per-element gradient/divergence assembly is vectorized numpy mirroring
`geometry/fem.py::gradient_operator`. A copy of
`eigenpinns_tpu/geometry/geodesics.py` on the port's `fem.py` and
`TriMesh`.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
from scipy.sparse.linalg import spsolve

from eigenpinns_torch.geometry.fem import (
    _triangle_geometry_np,
    assemble_stiffness_mass,
)
from eigenpinns_torch.geometry.mesh import TriMesh


def heat_geodesics(mesh: TriMesh, sources, dt: float | None = None,
                   K=None, M=None) -> np.ndarray:
    """Geodesic distance from `sources` (vertex indices) to all vertices."""
    verts = mesh.verts
    faces = np.asarray(mesh.faces, dtype=np.int64)
    n = mesh.n_verts
    if K is None or M is None:
        K, M = assemble_stiffness_mass(mesh)

    if dt is None:
        # Mean edge length squared (the heat-method default).
        e = verts[faces[:, [1, 2, 0]]] - verts[faces]
        dt = float(np.mean(np.linalg.norm(e, axis=2)) ** 2)

    sources = np.atleast_1d(np.asarray(sources, dtype=np.int64))
    u0 = np.zeros(n)
    u0[sources] = 1.0

    A = (M + dt * K).tocsc()
    u = spsolve(A, u0)

    # Per-element gradient in the local 2D frame: g2 = B @ u_e / J.
    B, J = _triangle_geometry_np(verts, faces)
    u_e = u[faces]                                  # (F, 3)
    g2 = np.einsum("fij,fj->fi", B, u_e) / J[:, None]  # (F, 2)
    norm = np.linalg.norm(g2, axis=1, keepdims=True)
    X2 = -g2 / np.maximum(norm, 1e-300)             # unit descent field

    # Divergence: node_f accumulates (B^T X)_f * J/2 per element — the
    # FEM weak divergence with element area J/2 (reference's ForceVector
    # convention B^T X / 2, src/Mesh.py:235-236, times the Jacobian).
    contrib = np.einsum("fij,fi->fj", B, X2) / 2.0  # (F, 3)
    div = np.zeros(n)
    np.add.at(div, faces.reshape(-1), contrib.reshape(-1))

    # Poisson solve; K has the constant nullspace — pin the first source.
    K_reg = (K + 1e-8 * sp.eye(n)).tocsc()
    phi = spsolve(K_reg, div)
    phi = phi - phi[sources].min()
    if phi.mean() < 0:  # orientation: distances are nonnegative outward
        phi = -phi
    phi = phi - phi[sources].min()
    return phi


def geodesic_ground_truth(mesh: TriMesh, sources) -> np.ndarray:
    """Named alias used by the eikonal app (the exact_geodesic stand-in)."""
    return heat_geodesics(mesh, sources)
