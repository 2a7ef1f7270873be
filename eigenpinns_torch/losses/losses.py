"""Composite physics losses for eigenfunction learning.

Port of every term of `eigenpinns_tpu/losses/losses.py`:

  rayleigh_residual_orth   lam, ||K U - M U diag(lam)||^2, ||U^T M U - I||^2/k
  rayleigh_and_residual    lam, ||K U - M U diag(lam)||^2
  gram_orthogonality       ||U^T M U - I||^2 / k
  normalization            (u^T M u - 1)^2
  deflation                sum_j (u^T M u_j)^2
  trace_loss / ordering / eigenvalue_target       src/multigrid_model.py:326-348
  zero_mean                (1^T M u)^2 for modes >= 1
  zero_lambda              lambda_0^2 rigid-body pin
  diversity                min-gap hinge between consecutive lambdas
  smoothness               mean of u^T K u
  projection               ||P^T U_f - U_c||^2
"""

from __future__ import annotations

import torch

from eigenpinns_torch.sparse.ops import gram, spmm, spmm_gram


def rayleigh_residual_orth(U, K, M, eps: float = 1e-12):
    """(lam, residual_mse, orth) from the fused K U / U^T K U and
    M U / U^T M U products (src/multigrid_model.py:309-322)."""
    Ku, Gk = spmm_gram(K, U)
    Mu, Gm = spmm_gram(M, U)
    lam = torch.diagonal(Gk) / (torch.diagonal(Gm) + eps)
    res = Ku - Mu * lam[None, :]
    k = U.shape[1]
    orth = ((Gm - torch.eye(k, dtype=U.dtype, device=U.device)) ** 2).sum() / k
    return lam, (res**2).mean(), orth


def rayleigh_and_residual(U, K, M, eps: float = 1e-12):
    """(lam, residual_mse): per-mode Rayleigh quotients and the mean
    squared eigen-residual, sharing the K U / M U products."""
    Ku = spmm(K, U)
    Mu = spmm(M, U)
    lam = (U * Ku).sum(0) / ((U * Mu).sum(0) + eps)
    res = Ku - Mu * lam[None, :]
    return lam, (res**2).mean()


def gram_orthogonality(U, M):
    """||U^T M U - I||_F^2 / k (the reference divides by n_modes)."""
    k = U.shape[1]
    G = gram(U, spmm(M, U))
    return ((G - torch.eye(k, dtype=U.dtype, device=U.device)) ** 2).sum() / k


def normalization(u, M):
    """(u^T M u - 1)^2 for a single mode u: (N,) or (N, 1)."""
    u = u.reshape(-1)
    return (u @ spmm(M, u[:, None])[:, 0] - 1.0) ** 2


def deflation(u, M, U_prev):
    """sum_j (u^T M u_j)^2: push u out of the span of converged modes."""
    u = u.reshape(-1)
    return (gram(spmm(M, u[:, None]), U_prev) ** 2).sum()


def trace_loss(lam):
    """mean(lam): minimizing the subspace trace drives towards the bottom
    of the spectrum."""
    return lam.mean()


def ordering(lam):
    """sum relu(lam_i - lam_{i+1}): penalize out-of-order eigenvalues."""
    return torch.relu(lam[:-1] - lam[1:]).sum()


def eigenvalue_target(lam, lam_target):
    return ((lam - lam_target) ** 2).mean()


def zero_mean(U, M, skip_first: bool = True):
    """(1^T M u_j)^2 summed over modes j >= 1 (mode 0 is the constant)."""
    m_row = spmm(M, torch.ones((U.shape[0], 1), dtype=U.dtype,
                               device=U.device))[:, 0]
    moments = m_row @ U
    if skip_first:
        moments = moments[1:]
    return (moments**2).sum()


def zero_lambda(lam):
    """lam_0^2: pin the rigid-body mode to zero."""
    return lam[0] ** 2


def diversity(lam, min_gap: float):
    """Hinge on consecutive gaps: sum relu(min_gap - (lam_{i+1} - lam_i))."""
    return torch.relu(min_gap - (lam[1:] - lam[:-1])).sum()


def smoothness(U, K):
    """Mean of u^T K u: Dirichlet-energy smoothing of predictions."""
    return (U * spmm(K, U)).sum(0).mean()


def projection(U_fine, Pt, U_coarse):
    """||P^T U_f - U_c||^2: anchor fine predictions to the coarse level."""
    return ((spmm(Pt, U_fine) - U_coarse) ** 2).mean()
