"""Surface eikonal operator: per-element gradient-norm residuals.

Port of `eigenpinns_tpu/operators/eikonal.py` (the Laplace-PINN-coil
notebook's PDE machinery, cells 7 and 16): the squared surface gradient
of a P1 field on element e is u_e^T Bs_e u_e with Bs_e = B_e^T B_e / J_e^2
precomputed on the host in float64 from the FEM B-matrices; the eikonal
residual is sqrt(u^T Bs u) - 1.
"""

from __future__ import annotations

import numpy as np
import torch

from eigenpinns_torch.geometry.fem import _triangle_geometry_np


def gradient_norm_operator(verts: np.ndarray, faces: np.ndarray):
    """(F, 3, 3) per-element operator Bs = B^T B / J^2 (cell 16:15-21),
    float64 on the host."""
    B, J = _triangle_geometry_np(np.asarray(verts, np.float64),
                                 np.asarray(faces, np.int64))
    return np.einsum("fik,fil->fkl", B, B) / (J**2)[:, None, None]


def eikonal_residual(u: torch.Tensor, Bs: torch.Tensor,
                     faces: torch.Tensor) -> torch.Tensor:
    """sqrt(u_e^T Bs_e u_e) - 1 per element (cell 7:41-53): the surface
    gradient magnitude of a distance field must be one."""
    u_e = u[faces]                                   # (F, 3)
    quad = torch.einsum("fij,fi,fj->f", Bs, u_e, u_e)
    return torch.sqrt(torch.clamp(quad, min=1e-12)) - 1.0


def eigen_positional_encoding(U: np.ndarray, n_eigs: int) -> np.ndarray:
    """Per-vertex features = the first n_eigs Laplace-Beltrami
    eigenfunctions -- the Delta-PINN positional encoding (cell 20)."""
    return np.asarray(U[:, :n_eigs], dtype=np.float32)
