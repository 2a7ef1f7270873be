"""Dense k x k generalized eigensolves and Rayleigh-Ritz refinement.

Port of `eigenpinns_tpu/solvers/rayleigh_ritz.py`: the k x k problem
stays on the operator's device (Cholesky reduction, or spectral-filtered
whitening when the mass Gram may be near-singular). The Grams sum over
every shard of a sharded operator's rows (`node_reduce`).

Each k x k Gram runs in a `lobpcg.gram` span (`node_gram`) and each dense
eigensolve in a `lobpcg.eigh` span (`eigh`), which counts its host sync
(`sync.eigh`): on CUDA `torch.linalg.eigh` checks its result on the host.
"""

from __future__ import annotations

import torch

from eigenpinns_torch.sparse.ops import gram, hdot, node_reduce, spmm
from eigenpinns_torch.utils.profiling import count, span


def node_gram(M, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """U^T V summed over every shard of M's rows."""
    with span("lobpcg.gram"):
        return node_reduce(M, gram(U, V))


def eigh(A: torch.Tensor):
    """`torch.linalg.eigh(A)`, a host sync on CUDA."""
    with span("lobpcg.eigh"):
        count("sync.eigh")
        return torch.linalg.eigh(A)


def eigh_generalized(A: torch.Tensor, B: torch.Tensor, jitter: float = 0.0):
    """Solve A C = B C diag(w), A symmetric, B SPD. Returns (w, C)
    ascending, via B = L L^T and the standard problem L^-1 A L^-T."""
    k = A.shape[0]
    if jitter:
        B = B + jitter * torch.eye(k, dtype=B.dtype, device=B.device)
    L = torch.linalg.cholesky(B)
    Y = torch.linalg.solve_triangular(L, A, upper=False)
    C_std = torch.linalg.solve_triangular(L, Y.T, upper=False).T
    C_std = 0.5 * (C_std + C_std.T)
    w, V = eigh(C_std)
    return w, torch.linalg.solve_triangular(L.T, V, upper=True)


def filtered_whiten(S: torch.Tensor, G: torch.Tensor, eps: float = 1e-6):
    """Spectral B-whitening of a basis S with Gram G = S^T B S.

    Returns (S W, good, W) with W = V diag(e^-1/2) from G's
    eigendecomposition; `good` marks the directions kept
    (e > eps * e_max). Dropped directions become zero columns.
    """
    G = 0.5 * (G + G.T)
    e, V = eigh(G)
    good = e > eps * torch.clamp(e[-1], min=1e-30)
    inv = torch.where(good, torch.rsqrt(torch.clamp(e, min=1e-30)),
                      torch.zeros_like(e))
    Wh = V * inv[None, :]
    return hdot(S, Wh), good, Wh


def rayleigh_ritz(U: torch.Tensor, K, M, jitter: float = 0.0):
    """Solve the projected problem (U^T K U, U^T M U) and rotate U
    (src/multigrid_model.py:386-408)."""
    A = node_gram(M, U, spmm(K, U))
    B = node_gram(M, U, spmm(M, U))
    w, C = eigh_generalized(0.5 * (A + A.T), 0.5 * (B + B.T), jitter=jitter)
    return w, hdot(U, C)


def rayleigh_ritz_robust(U: torch.Tensor, K, M, eps: float = 1e-6):
    """Rayleigh-Ritz with spectral filtering of the mass Gram: dependent
    directions are dropped and their Ritz values pushed to a sentinel."""
    B = node_gram(M, U, spmm(M, U))
    Uw, good, _ = filtered_whiten(U, B, eps=eps)
    A = node_gram(M, Uw, spmm(K, Uw))
    A = 0.5 * (A + A.T)
    big = 10.0 * A.diagonal().abs().max() + 1.0
    A = A + torch.diag(torch.where(good, torch.zeros_like(big), big))
    w, V = eigh(A)
    return w, hdot(Uw, V)
