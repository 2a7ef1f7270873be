"""Physics loss terms of the multigrid trainer.

Port of the terms of `eigenpinns_tpu/losses/losses.py` that the
multigrid training path uses:

  rayleigh_residual_orth   lam, ||K U - M U diag(lam)||^2, ||U^T M U - I||^2/k
  trace_loss / ordering / eigenvalue_target       src/multigrid_model.py:326-348
  zero_mean                (1^T M u)^2 for modes >= 1
  projection               ||P^T U_f - U_c||^2
"""

from __future__ import annotations

import torch

from eigenpinns_torch.sparse.ops import spmm, spmm_gram


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


def projection(U_fine, Pt, U_coarse):
    """||P^T U_f - U_c||^2: anchor fine predictions to the coarse level."""
    return ((spmm(Pt, U_fine) - U_coarse) ** 2).mean()
