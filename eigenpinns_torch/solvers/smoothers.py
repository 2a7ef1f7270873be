"""Smoothers and coarse-grid correction for the multigrid hierarchy.

Port of `eigenpinns_tpu/solvers/smoothers.py`: fixed-iteration linear
iterations over SpMM, with the JAX `fori_loop`s as Python loops (the
loops enqueue device work and never read a value back).
"""

from __future__ import annotations

import torch

from eigenpinns_torch.sparse.ops import spmm
from eigenpinns_torch.solvers.rayleigh_ritz import rayleigh_ritz


def jacobi_smooth(M, K, U_rough: torch.Tensor, alpha: float = 0.05,
                  n_iters: int = 5) -> torch.Tensor:
    """Approximately solve (M + alpha K) U = M U_rough by damped Jacobi,
    starting from U = U_rough (src/utils.py:220-232)."""
    d_inv = 1.0 / (M.diagonal() + alpha * K.diagonal() + 1e-12)
    MU_rough = spmm(M, U_rough)
    U = U_rough
    for _ in range(n_iters):
        resid = MU_rough - (spmm(M, U) + alpha * spmm(K, U))
        U = U + d_inv[:, None] * resid
    return U


def cg_solve(A, B_rhs: torch.Tensor, n_iters: int = 50,
             ridge: float = 0.0) -> torch.Tensor:
    """Blocked conjugate gradient for (A + ridge I) X = B_rhs, X (N, k)."""
    def matvec(X):
        return spmm(A, X) + ridge * X

    X = torch.zeros_like(B_rhs)
    R = B_rhs - matvec(X)
    P = R
    rs = (R * R).sum(0)
    for _ in range(n_iters):
        AP = matvec(P)
        alpha = rs / torch.clamp((P * AP).sum(0), min=1e-30)
        X = X + P * alpha[None, :]
        R = R - AP * alpha[None, :]
        rs_new = (R * R).sum(0)
        beta = rs_new / torch.clamp(rs, min=1e-30)
        P = R + P * beta[None, :]
        rs = rs_new
    return X


def coarse_grid_correction(U_fine, K_fine, M_fine, K_coarse, P, Pt,
                           ridge: float = 1e-6, cg_iters: int = 100):
    """One multigrid CGC step: U - P (K_c + ridge I)^-1 P^T (K U - M U L)
    (src/multigrid_model.py:410-450). Returns (U_cgc, lambda_fine)."""
    lam_f, _ = rayleigh_ritz(U_fine, K_fine, M_fine)
    R_f = spmm(K_fine, U_fine) - spmm(M_fine, U_fine) * lam_f[None, :]
    delta_c = cg_solve(K_coarse, spmm(Pt, R_f), n_iters=cg_iters,
                       ridge=ridge)
    return U_fine - spmm(P, delta_c), lam_f
