"""P1 finite-element assembly of Laplace-Beltrami operators on triangle meshes.

Port of `eigenpinns_tpu/geometry/fem.py`: all F elements are assembled
at once with vectorized torch ops on the inputs' device and scattered
with `index_add_` (the JAX package's `segment_sum`), instead of the
reference's per-element Python loop (`src/Mesh.py:348-364` calling
`Bmatrix`/`StiffnessMatrix`/`MassMatrix`, `src/Mesh.py:180-234`). The
host assembly (`assemble_stiffness_mass`) is a float64 numpy copy.

Conventions (matched to the reference for numerical parity):
  * per-triangle local frame: e1 = normalize(p1 - p0),
    e2 = normalize((p2 - p0) orthogonalized against e1)        (Mesh.py:182-184)
  * J = x13*y23 - y31*x32  (= 2 * area)                        (Mesh.py:194)
  * B = [[y23, y31, y12], [x32, x13, x21]]                      (Mesh.py:196)
  * element stiffness  k = B^T B / (2 J)                        (Mesh.py:228-229)
  * element consistent mass  m = [[2,1,1],[1,2,1],[1,1,2]] J/12 (Mesh.py:230-234)
    NOTE: with J = 2*area this is 2x the textbook P1 mass; kept as-is for
    eigenvalue parity with the reference discretization.
  * lumped mass: row-sums of the consistent mass (J/3 per corner).

The device assembly returns COO triplets with duplicates (duplicate
entries are additive); host-side canonicalization to CSR happens once in
preprocessing.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch


def _frame(p0, p1, p2):
    """The local frame (e1, e2) of each triangle."""
    d10 = p1 - p0
    d20 = p2 - p0
    e1 = d10 / (torch.linalg.vector_norm(d10, dim=1, keepdim=True) + 1e-300)
    e2 = d20 - (d20 * e1).sum(dim=1, keepdim=True) * e1
    e2 = e2 / (torch.linalg.vector_norm(e2, dim=1, keepdim=True) + 1e-300)
    return e1, e2


def triangle_geometry(verts: torch.Tensor, faces: torch.Tensor):
    """Per-triangle local 2D frame quantities.

    Returns (B, J) with B: (F, 2, 3) gradient matrix in the local frame and
    J: (F,) twice the triangle area (the reference's Jacobian, Mesh.py:194).
    """
    p = verts[faces.long()]  # (F, 3, 3)
    p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]
    e1, e2 = _frame(p0, p1, p2)

    def dot(a, b):
        return (a * b).sum(dim=1)

    x21 = dot(p1 - p0, e1)
    x13 = dot(p0 - p2, e1)
    x32 = dot(p2 - p1, e1)
    y23 = dot(p1 - p2, e2)
    y31 = dot(p2 - p0, e2)
    y12 = dot(p0 - p1, e2)

    J = x13 * y23 - y31 * x32
    B = torch.stack(
        [torch.stack([y23, y31, y12], dim=1),
         torch.stack([x32, x13, x21], dim=1)],
        dim=1,
    )  # (F, 2, 3)
    return B, J


def element_stiffness(B: torch.Tensor, J: torch.Tensor) -> torch.Tensor:
    """(F, 3, 3) element stiffness k = B^T B / (2 J)."""
    return torch.einsum("fik,fil->fkl", B, B) / (2.0 * J)[:, None, None]


_MASS_TEMPLATE = np.array(
    [[2.0, 1.0, 1.0], [1.0, 2.0, 1.0], [1.0, 1.0, 2.0]]) / 12.0


def element_mass(J: torch.Tensor) -> torch.Tensor:
    """(F, 3, 3) consistent element mass m = [[2,1,1],[1,2,1],[1,1,2]] J/12."""
    return (torch.as_tensor(_MASS_TEMPLATE, dtype=J.dtype, device=J.device)
            * J[:, None, None])


def _segment_sum(values: torch.Tensor, segments: torch.Tensor,
                 n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=values.dtype, device=values.device
                       ).index_add_(0, segments.long(), values)


def assemble_coo(verts: torch.Tensor, faces: torch.Tensor,
                 lumped: bool = False):
    """Assemble stiffness and mass COO triplets for all elements at once.

    Returns ``(rows, cols, k_vals, m_vals)`` each of length 9*F (COO with
    duplicates; duplicate entries are additive). When ``lumped`` is true,
    ``m_vals`` instead holds the (V,) diagonal lumped mass and only
    ``(rows, cols, k_vals)`` refer to the 9*F stiffness layout.
    """
    B, J = triangle_geometry(verts, faces)
    k_loc = element_stiffness(B, J)  # (F, 3, 3)

    fi = faces[:, :, None]  # (F, 3, 1)
    fj = faces[:, None, :]  # (F, 1, 3)
    rows = fi.expand(k_loc.shape).reshape(-1)
    cols = fj.expand(k_loc.shape).reshape(-1)
    k_vals = k_loc.reshape(-1)

    if lumped:
        # Row-sum lumping: each corner receives J/3 (= 2*area/3).
        contrib = (J / 3.0)[:, None].expand(faces.shape).reshape(-1)
        m_diag = _segment_sum(contrib, faces.reshape(-1), verts.shape[0])
        return rows, cols, k_vals, m_diag

    m_vals = element_mass(J).reshape(-1)
    return rows, cols, k_vals, m_vals


def _triangle_geometry_np(verts: np.ndarray, faces: np.ndarray):
    """Float64 numpy mirror of `triangle_geometry` for host-side assembly.

    Kept separate so offline preprocessing and test oracles run in f64.
    """
    p = verts[faces]
    p0, p1, p2 = p[:, 0], p[:, 1], p[:, 2]
    d10, d20 = p1 - p0, p2 - p0
    e1 = d10 / (np.linalg.norm(d10, axis=1, keepdims=True) + 1e-300)
    e2 = d20 - np.sum(d20 * e1, axis=1, keepdims=True) * e1
    e2 = e2 / (np.linalg.norm(e2, axis=1, keepdims=True) + 1e-300)

    def dot(a, b):
        return np.sum(a * b, axis=1)

    x21, x13, x32 = dot(p1 - p0, e1), dot(p0 - p2, e1), dot(p2 - p1, e1)
    y23, y31, y12 = dot(p1 - p2, e2), dot(p2 - p0, e2), dot(p0 - p1, e2)
    J = x13 * y23 - y31 * x32
    B = np.stack(
        [np.stack([y23, y31, y12], axis=1),
         np.stack([x32, x13, x21], axis=1)],
        axis=1,
    )
    return B, J


def assemble_stiffness_mass(mesh, lumped: bool = False):
    """Host-side f64 assembly: TriMesh -> canonical scipy CSR (K, M).

    The reference exposes the same capability as
    `mesh_helpers.compute_stiffness_and_mass_matrices`
    (src/mesh_helpers.py:57-59), returning scipy sparse; used in offline
    preprocessing and test oracles.
    """
    verts = np.asarray(mesh.verts, dtype=np.float64)
    faces = np.asarray(mesh.faces)
    B, J = _triangle_geometry_np(verts, faces)
    k_loc = np.einsum("fik,fil->fkl", B, B) / (2.0 * J)[:, None, None]
    rows = np.broadcast_to(faces[:, :, None], k_loc.shape).reshape(-1)
    cols = np.broadcast_to(faces[:, None, :], k_loc.shape).reshape(-1)
    n = mesh.n_verts
    K = sp.coo_matrix((k_loc.reshape(-1), (rows, cols)), shape=(n, n)).tocsr()
    if lumped:
        m_diag = np.zeros(n)
        np.add.at(m_diag, faces.reshape(-1),
                  np.broadcast_to((J / 3.0)[:, None], faces.shape).reshape(-1))
        M = sp.diags(m_diag).tocsr()
    else:
        m_loc = _MASS_TEMPLATE[None] * J[:, None, None]
        M = sp.coo_matrix((m_loc.reshape(-1), (rows, cols)),
                          shape=(n, n)).tocsr()
    return K, M


def element_force(B: torch.Tensor, J: torch.Tensor,
                  X: torch.Tensor) -> torch.Tensor:
    """Per-element P1 load vector f = B^T X / 2.

    Parity with the reference's `Mesh.ForceVector` (src/Mesh.py:235-236;
    J is accepted but unused there too). X: (F, 2) is a constant
    per-element vector field expressed in the element's LOCAL 2D frame
    (the reference's "not rotated" Xnr, src/Mesh.py:289-291). Since
    grad(phi) = B/J in that frame and the element area is J/2,
    f_i = integral grad(phi_i) . X = B^T X / 2 — the divergence-type
    load the heat-method geodesic Poisson step assembles
    (src/Mesh.py:283-292).
    """
    del J  # kept for signature parity with the reference
    return torch.einsum("fde,fd->fe", B, X) / 2.0


def assemble_force(verts: torch.Tensor, faces: torch.Tensor,
                   X: torch.Tensor) -> torch.Tensor:
    """Assembled (V,) load vector for a per-element local-frame field X.

    Vectorized `index_add_` assembly of `element_force` over all F
    elements. If X_f = (B_f u[faces_f]) / J_f (the local-frame gradient
    of a nodal field u), then assemble_force == K @ u with K the
    assembled P1 stiffness — integration by parts at the discrete level.
    """
    B, J = triangle_geometry(verts, faces)
    f_loc = element_force(B, J, X)  # (F, 3)
    return _segment_sum(f_loc.reshape(-1), faces.reshape(-1),
                        verts.shape[0])


def gradient_operator(verts: torch.Tensor, faces: torch.Tensor):
    """Per-element 3D gradient operator.

    Returns (G, J) with G: (F, 3, 3) mapping the 3 nodal values of element f
    to the 3D surface gradient (rows are x/y/z components), i.e.
    grad u|_f = G[f] @ u[faces[f]]. Mirrors `Mesh.gradient`
    (src/Mesh.py:200-226) vectorized over all elements:
    grad = R @ [B @ u / J; 0].
    """
    p = verts[faces.long()]
    e1, e2 = _frame(p[:, 0], p[:, 1], p[:, 2])
    B, J = triangle_geometry(verts, faces)
    # R = [e1 e2] as (F, 3, 2); G = R @ B / J
    R = torch.stack([e1, e2], dim=2)
    G = torch.einsum("fce,fen->fcn", R, B) / J[:, None, None]
    return G, J
