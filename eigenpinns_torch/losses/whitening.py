"""Differentiable M-orthonormalization (whitening) of eigenbases.

Port of `eigenpinns_tpu/losses/whitening.py`, all in fp32:

  * Newton-Schulz: the coupled iteration towards G^{-1/2} with matmuls
    only (scripts/simplified_loss.ipynb cell 0:44-87);
  * spectral whitening: U B^{-1/2} from eigh of B = U^T M U, with the
    conditioning guard whose absence sank the reference's k = 50 run
    (loss_with_rigid_body.ipynb cell 0:214-222).

Both return U_orth with U_orth^T M U_orth ~= I, differentiable end to end.
"""

from __future__ import annotations

import torch

from eigenpinns_torch.sparse.ops import gram, hdot, spmm


def newton_schulz_inv_sqrt(G: torch.Tensor, n_iters: int = 5):
    """A^{-1/2} for SPD A by the coupled Newton-Schulz iteration, after a
    Frobenius pre-scaling that makes it converge."""
    eye = torch.eye(G.shape[0], dtype=G.dtype, device=G.device)
    scale = torch.sqrt((G * G).sum())
    Y, Z = G / scale, eye
    for _ in range(n_iters):
        T = 0.5 * (3.0 * eye - hdot(Z, Y))
        Y, Z = hdot(Y, T), hdot(T, Z)
    return Z / torch.sqrt(scale)


def _sym_gram(U, M):
    G = gram(U, spmm(M, U))
    return 0.5 * (G + G.T)


def newton_schulz_orthonormalize(U, M, n_iters: int = 5):
    """U @ (U^T M U)^{-1/2} via Newton-Schulz."""
    return hdot(U, newton_schulz_inv_sqrt(_sym_gram(U, M), n_iters=n_iters))


def spectral_orthonormalize(U, M, cond_clip: float = 1e6):
    """U B^{-1/2} with B^{-1/2} from eigh; Gram eigenvalues below
    max / cond_clip are clipped before the inverse square root."""
    e, V = torch.linalg.eigh(_sym_gram(U, M))
    e = torch.clamp(e, min=e.max() / cond_clip)
    return hdot(U, hdot(V * torch.rsqrt(e)[None, :], V.T))


def gram_condition_penalty(U, M, eps: float = 1e-12):
    """log(e_max / e_min) of the Gram, the stability regularizer of
    loss_with_rigid_body.ipynb cell 0:263-265 in a smooth form."""
    e = torch.linalg.eigvalsh(_sym_gram(U, M))
    return torch.log(torch.clamp(e[-1], min=eps) / torch.clamp(e[0], min=eps))
