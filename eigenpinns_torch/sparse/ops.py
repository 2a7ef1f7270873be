"""Sparse linear algebra on torch: SpMM dispatch, Gram reductions.

Port of `eigenpinns_tpu/sparse/ops.py`. The ELL product is a gather of U
rows by the padded column indices and a contraction over the width axis;
its backward pass is a second gather on the stored transpose, so neither
direction scatters (no `index_add_`). Every Gram / Rayleigh product runs
in full fp32: the package disables TF32 on import (see `__init__`), which
is the torch form of the reference's `hdot` rule (ops.py:49-55).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from eigenpinns_torch.sparse.bsr import BSRTile, bsr_spmm, bsr_spmm_gram
from eigenpinns_torch.sparse.formats import Diagonal, SparseELL
from eigenpinns_torch.sparse.rolling import (
    RollingBanded,
    rolling_spmm,
    rolling_spmm_gram,
)


def hdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Full-f32 matmul for orthogonalization/Gram arithmetic (TF32 off)."""
    return a @ b


def _gather_spmm(indices: torch.Tensor, values: torch.Tensor,
                 U: torch.Tensor) -> torch.Tensor:
    """Raw ELL SpMM: gather U rows by padded column indices (an (N, W, k)
    intermediate), contract W."""
    return torch.einsum("nwk,nw->nk", U[indices], values)


class _EllSpmm(torch.autograd.Function):
    """ELL SpMM whose backward pass gathers on the EXPLICIT transpose."""

    @staticmethod
    def forward(ctx, U, indices, values, t_indices, t_values):
        ctx.save_for_backward(t_indices, t_values)
        return _gather_spmm(indices, values, U)

    @staticmethod
    def backward(ctx, g):
        t_indices, t_values = ctx.saved_tensors
        return _gather_spmm(t_indices, t_values, g), None, None, None, None


def spmm(A, U: torch.Tensor) -> torch.Tensor:
    """A @ U for A in {Diagonal, SparseELL, RollingBanded, BSRTile},
    U (N, k)."""
    if isinstance(A, Diagonal):
        return A.diag[:, None] * U
    if isinstance(A, SparseELL):
        t = A.transpose_ell if A.transpose_ell is not None else A
        return _EllSpmm.apply(U, A.indices, A.values, t.indices, t.values)
    if isinstance(A, RollingBanded):
        return rolling_spmm(A, U)
    if isinstance(A, BSRTile):
        return bsr_spmm(A, U)
    raise TypeError(f"unsupported operator {type(A)}")


def spmv(A, u: torch.Tensor) -> torch.Tensor:
    """A @ u for a single vector (N,)."""
    return spmm(A, u[:, None])[:, 0]


def spmm_gram(A, U: torch.Tensor):
    """(A @ U, U^T A U): one fused kernel pass for the rolling band, the
    kernel plus an fp32 matmul epilogue for strip-BSR, the two-pass form
    for other formats."""
    if isinstance(A, RollingBanded):
        return rolling_spmm_gram(A, U)
    if isinstance(A, BSRTile):
        return bsr_spmm_gram(A, U)
    W = spmm(A, U)
    return W, gram(U, W)


def gram(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """U^T V (k x k), full f32."""
    return hdot(U.T, V)


def m_gram(U: torch.Tensor, M) -> torch.Tensor:
    """U^T M U — the M-inner-product Gram matrix."""
    return gram(U, spmm(M, U))


def rayleigh_quotients(U: torch.Tensor, K, M,
                       eps: float = 1e-12) -> torch.Tensor:
    """Per-mode Rayleigh quotients diag(U^T K U) / diag(U^T M U)."""
    Ku = spmm(K, U)
    Mu = spmm(M, U)
    return (U * Ku).sum(0) / ((U * Mu).sum(0) + eps)


def m_normalize_columns(U: torch.Tensor, M,
                        eps: float = 1e-12) -> torch.Tensor:
    """Normalize each column to unit M-norm."""
    Mu = spmm(M, U)
    return U / torch.sqrt((U * Mu).sum(0) + eps)[None, :]


def residual(U: torch.Tensor, K, M, lam: torch.Tensor) -> torch.Tensor:
    """Eigen-residual K U - M U diag(lam), shape (N, k)."""
    return spmm(K, U) - spmm(M, U) * lam[None, :]


def gcn_normalized_adjacency(edge_index, n_nodes: int, device="cpu",
                             dtype=torch.float32) -> SparseELL:
    """D^{-1/2} (A + I) D^{-1/2} as SparseELL — the SpectralCorrector's
    aggregation operator (src/utils.py:78-124). Host-side build."""
    e = np.asarray(edge_index)
    A = sp.coo_matrix((np.ones(e.shape[1]), (e[0], e[1])),
                      shape=(n_nodes, n_nodes))
    A = (A + sp.eye(n_nodes)).tocsr()
    A.sum_duplicates()
    A.data[:] = 1.0  # A+I with binarized duplicates, matching coalesce()
    deg = np.asarray(A.sum(axis=1)).ravel()
    d = 1.0 / np.sqrt(np.clip(deg, 1e-12, None))
    A = sp.diags(d) @ A @ sp.diags(d)
    return SparseELL.from_scipy(A, dtype=dtype, device=device)


def neighbor_mean_scipy(edge_index, n_nodes: int):
    """The mean-aggregation matrix D^{-1} A as scipy CSR."""
    e = np.asarray(edge_index)
    A = sp.coo_matrix((np.ones(e.shape[1]), (e[0], e[1])),
                      shape=(n_nodes, n_nodes)).tocsr()
    A.sum_duplicates()
    deg = np.asarray(A.sum(axis=1)).ravel()
    return (sp.diags(1.0 / np.clip(deg, 1.0, None)) @ A).tocsr()


def neighbor_mean_operator(edge_index, n_nodes: int, device="cpu",
                           dtype=torch.float32) -> SparseELL:
    """D^{-1} A as SparseELL with its transpose attached:
    `spmm(op, x)[i]` is the mean of x over i's out-neighbors."""
    return SparseELL.from_scipy(neighbor_mean_scipy(edge_index, n_nodes),
                                dtype=dtype, device=device)
