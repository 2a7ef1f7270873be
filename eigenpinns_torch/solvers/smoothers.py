"""Smoothers and coarse-grid correction for the multigrid hierarchy.

Port of `eigenpinns_tpu/solvers/smoothers.py`: fixed-iteration linear
iterations over SpMM, with the JAX `fori_loop`s as Python loops (the
loops enqueue device work and never read a value back).
"""

from __future__ import annotations

import torch

from eigenpinns_torch.sparse.ops import m_gram, spmm
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


def _block_cg(matvec, rhs: torch.Tensor, X: torch.Tensor,
              n_iters: int) -> torch.Tensor:
    """`n_iters` iterations of column-wise conjugate gradient on
    matvec(X) = rhs from X, each column its own step lengths, with the
    JAX package's clamps of 1e-30 on the denominators."""
    R = rhs - matvec(X)
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


def cg_solve(A, B_rhs: torch.Tensor, n_iters: int = 50,
             ridge: float = 0.0) -> torch.Tensor:
    """Blocked conjugate gradient for (A + ridge I) X = B_rhs, X (N, k)."""
    return _block_cg(lambda X: spmm(A, X) + ridge * X, B_rhs,
                     torch.zeros_like(B_rhs), n_iters)


def smooth_eigenfunctions(M, K, U: torch.Tensor, tau: float = 0.1,
                          n_iters: int = 30) -> torch.Tensor:
    """Implicit spectral smoothing: solve (M + tau K) U_new = M U by
    `n_iters` blocked CG iterations from U (the notebook's
    `smooth_eigenfunctions`, multigrid_gnn_refine_fixed.ipynb cell
    4:556-576, solved there by a host spsolve). K is applied 1 + n_iters
    times: once for the first residual, once an iteration."""
    return _block_cg(lambda X: spmm(M, X) + tau * spmm(K, X), spmm(M, U),
                     U, n_iters)


def m_orthonormalize_cholesky(U: torch.Tensor, M) -> torch.Tensor:
    """Cholesky M-orthonormalization: U L^-T with L L^T the symmetrized
    fp32 Gram U^T M U, by a triangular solve (the notebook's
    `m_orthonormalize`, cell 4:578-599; callers with suspect bases use
    `filtered_whiten`)."""
    G = m_gram(U, M)
    L = torch.linalg.cholesky(0.5 * (G + G.T))
    return torch.linalg.solve_triangular(L, U.T, upper=False).T


def coarse_grid_correction(U_fine, K_fine, M_fine, K_coarse, P, Pt,
                           ridge: float = 1e-6, cg_iters: int = 100):
    """One multigrid CGC step: U - P (K_c + ridge I)^-1 P^T (K U - M U L)
    (src/multigrid_model.py:410-450). Returns (U_cgc, lambda_fine)."""
    lam_f, _ = rayleigh_ritz(U_fine, K_fine, M_fine)
    R_f = spmm(K_fine, U_fine) - spmm(M_fine, U_fine) * lam_f[None, :]
    delta_c = cg_solve(K_coarse, spmm(Pt, R_f), n_iters=cg_iters,
                       ridge=ridge)
    return U_fine - spmm(P, delta_c), lam_f
