"""Sparse matrix containers on torch tensors.

Port of `eigenpinns_tpu/sparse/formats.py`. Every operator is built ONCE
on the host from a scipy matrix into a fixed device layout:

    SparseELL  padded row-major ELLPACK: indices (N, W) int64, values
               (N, W) float, W = max row degree rounded up to 8; plus
               an explicit transpose for nonsymmetric matrices, so the
               SpMM backward pass is a gather too (sparse/ops.py)
    Diagonal   a lumped mass matrix

The JAX package registers these as pytrees; here they are plain frozen
dataclasses holding tensors on one device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SparseELL:
    """Padded row-major sparse matrix (ELLPACK).

    `transpose_ell` stores A^T in the same layout for the scatter-free
    SpMM backward pass; None means A is symmetric and its own transpose.
    """

    indices: torch.Tensor          # (N, W) int64
    values: torch.Tensor           # (N, W) float
    n_cols: int
    transpose_ell: "SparseELL | None" = None

    @property
    def shape(self):
        return (self.indices.shape[0], self.n_cols)

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, device="cuda",
                   pad_multiple: int = 8, with_transpose: bool = True):
        """Canonicalize any scipy sparse matrix into ELL (host-side, once).

        Unless the matrix is (numerically) symmetric, its transpose is
        also converted and attached.
        """
        A = A.tocsr()
        A.sum_duplicates()
        n, m = A.shape

        def _pack(B):
            nn = B.shape[0]
            deg = np.diff(B.indptr)
            w = max(_round_up(int(deg.max()) if nn else 1, pad_multiple),
                    pad_multiple)
            indices = np.zeros((nn, w), dtype=np.int64)
            values = np.zeros((nn, w), dtype=np.float64)
            rows = np.repeat(np.arange(nn), deg)
            pos = np.arange(B.nnz) - np.repeat(B.indptr[:-1], deg)
            indices[rows, pos] = B.indices
            values[rows, pos] = B.data
            return (torch.as_tensor(indices, device=device),
                    torch.as_tensor(values, dtype=dtype, device=device))

        idx, vals = _pack(A)
        transpose = None
        if with_transpose:
            symmetric = False
            if n == m:
                d = (A - A.T).tocsr()
                symmetric = d.nnz == 0 or abs(d).max() < 1e-12 * max(
                    abs(A).max(), 1e-300)
            if not symmetric:
                ti, tv = _pack(A.T.tocsr())
                transpose = cls(ti, tv, n)
        return cls(idx, vals, m, transpose)

    def to_scipy(self):
        n, w = self.indices.shape
        rows = np.repeat(np.arange(n), w)
        A = sp.coo_matrix(
            (self.values.detach().cpu().double().numpy().reshape(-1),
             (rows, self.indices.cpu().numpy().reshape(-1))),
            shape=self.shape,
        ).tocsr()
        A.sum_duplicates()
        A.eliminate_zeros()   # padding added explicit zeros in column 0
        return A

    def diagonal(self) -> torch.Tensor:
        n = self.indices.shape[0]
        rows = torch.arange(n, device=self.indices.device)[:, None]
        return torch.where(self.indices == rows, self.values,
                           torch.zeros((), dtype=self.values.dtype,
                                       device=self.values.device)).sum(1)


@dataclasses.dataclass(frozen=True)
class Diagonal:
    """Diagonal operator (lumped mass matrices)."""

    diag: torch.Tensor   # (N,)

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, device="cuda"):
        return cls(torch.as_tensor(np.asarray(A.diagonal()), dtype=dtype,
                                   device=device))

    def diagonal(self) -> torch.Tensor:
        return self.diag


def as_operator(A, dtype=torch.float32, device="cuda", pad_multiple: int = 8):
    """scipy sparse -> Diagonal if (numerically) diagonal, else SparseELL."""
    if sp.issparse(A):
        if A.shape[0] == A.shape[1]:
            offdiag = (A - sp.diags(A.diagonal())).tocsr()
            if offdiag.nnz == 0 or abs(offdiag).max() == 0.0:
                return Diagonal.from_scipy(A, dtype=dtype, device=device)
        return SparseELL.from_scipy(A, dtype=dtype, device=device,
                                    pad_multiple=pad_multiple)
    raise TypeError(f"expected scipy sparse, got {type(A)}")
