"""Host-side classical eigensolver oracles (scipy/ARPACK).

The coarsest-level exact solve of the hierarchy build and the accuracy
oracle of the diagnostics, the tests and `chip_smoke.py` (the reference
uses them both ways, `src/utils.py:172-183`, `src/diagnostics.py:130-138`).
A copy of `eigenpinns_tpu/solvers/oracle.py`.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse.linalg import eigsh

from eigenpinns_torch.geometry.fem import assemble_stiffness_mass
from eigenpinns_torch.geometry.point_cloud import point_cloud_laplacian


def eigsh_smallest(K, M, k: int, sigma: float = -0.01, seed: int = 0):
    """Smallest-k generalized eigenpairs via shift-invert ARPACK.

    Functionally `eigsh(K, k, M, which='SM')` (src/utils.py:175) but in
    shift-invert mode. The Lanczos start vector ``v0`` is seeded so runs
    are reproducible.
    """
    v0 = np.random.default_rng(seed).standard_normal(K.shape[0])
    vals, vecs = eigsh(K, k=k, M=M, sigma=sigma, which="LM", v0=v0)
    order = np.argsort(vals)
    return vals[order], vecs[:, order]


def solve_eigenvalue_point_cloud(X: np.ndarray, n_modes: int,
                                 n_neighbors: int = 30):
    """Parity with `utils.solve_eigenvalue_point_cloud` (src/utils.py:172-176):
    returns (vals, vecs, L, M)."""
    L, M = point_cloud_laplacian(X, n_neighbors=n_neighbors)
    vals, vecs = eigsh_smallest(L, M, n_modes)
    return vals, vecs, L, M


def solve_eigenvalue_mesh(mesh, n_modes: int):
    """Parity with `utils.solve_eigenvalue_mesh` (src/utils.py:179-183):
    returns (vals, vecs, K, M)."""
    K, M = assemble_stiffness_mass(mesh)
    vals, vecs = eigsh_smallest(K, M, n_modes)
    return vals, vecs, K, M


def orthonormalize_gs(U: np.ndarray, M) -> np.ndarray:
    """Modified Gram-Schmidt in the M-inner product (src/utils.py:190-217)."""
    U_orth = np.zeros_like(U)
    for i in range(U.shape[1]):
        v = U[:, i].copy()
        for j in range(i):
            v -= (U_orth[:, j] @ (M @ v)) * U_orth[:, j]
        norm = np.sqrt(v @ (M @ v))
        U_orth[:, i] = v / (norm + 1e-12)
    return U_orth
