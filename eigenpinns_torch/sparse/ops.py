"""Sparse linear algebra on torch: SpMM dispatch, Gram reductions.

Port of `eigenpinns_tpu/sparse/ops.py`. The ELL product is a gather of U
rows by the padded column indices and a contraction over the width axis;
its backward pass is a second gather on the stored transpose, so neither
direction scatters (`neighbor_mean`, the segment-sum form of the mean
aggregation, is the module's one `index_add_`). Every Gram / Rayleigh product runs
in full fp32: the package disables TF32 on import (see `__init__`), which
is the torch form of the reference's `hdot` rule (ops.py:49-55).

Node-axis reductions (Grams, column sums) take their sum over the shards
from the operator (`node_reduce`): a `FunctionOperator` over a sharded
SpMM (`parallel/`) carries the all-reduce over the mesh's data axis, and
every other operator's rows are all on one device, so the local sum is
the whole.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from eigenpinns_torch.sparse.banded import (
    BandedELL,
    banded_spmm,
    banded_spmm_gram,
)
from eigenpinns_torch.sparse.bsr import BSRTile, bsr_spmm, bsr_spmm_gram
from eigenpinns_torch.sparse.formats import Diagonal, SparseELL
from eigenpinns_torch.sparse.rolling import (
    RollingBanded,
    rolling_spmm,
    rolling_spmm_gram,
)
from eigenpinns_torch.sparse.split import (
    SplitBanded,
    split_spmm,
    split_spmm_gram,
)


class FunctionOperator:
    """Duck-typed operator: any U -> A @ U callable plus its diagonal
    (port of the JAX `FunctionOperator`), accepted by `spmm` and by the
    solvers written against `spmm(A, U)` / `A.diagonal()`: the sharded
    SpMMs of `parallel/` in particular. On a sharded operator `fn` maps
    this rank's rows to this rank's rows, `diag` holds this rank's rows,
    `reduce` is the differentiable sum of a node-axis partial over the
    data axis, `n` the true (unpadded) global row count and `rows` this
    rank's (first row, padded global row count) in the global layout.
    `reduce=None` means one device."""

    def __init__(self, fn, diag, reduce=None, n: int | None = None,
                 rows: tuple | None = None):
        self.fn = fn
        self.diag = diag
        self.reduce = reduce
        self.n = n
        self.rows = rows

    def diagonal(self):
        return self.diag

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)


def node_reduce(A, x: torch.Tensor) -> torch.Tensor:
    """x, a partial sum over this rank's rows, summed over every shard
    of A's rows: A's all-reduce when A is sharded, else x itself."""
    red = getattr(A, "reduce", None)
    return x if red is None else red(x)


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
    """A @ U for A in {Diagonal, SparseELL, BandedELL, RollingBanded,
    SplitBanded, BSRTile}, U (N, k)."""
    if isinstance(A, Diagonal):
        return A.diag[:, None] * U
    if isinstance(A, SparseELL):
        t = A.transpose_ell if A.transpose_ell is not None else A
        return _EllSpmm.apply(U, A.indices, A.values, t.indices, t.values)
    if isinstance(A, BandedELL):
        return banded_spmm(A, U)
    if isinstance(A, RollingBanded):
        return rolling_spmm(A, U)
    if isinstance(A, SplitBanded):
        return split_spmm(A, U)
    if isinstance(A, BSRTile):
        return bsr_spmm(A, U)
    if isinstance(A, FunctionOperator):
        return A.fn(U)
    raise TypeError(f"unsupported operator {type(A)}")


def spmv(A, u: torch.Tensor) -> torch.Tensor:
    """A @ u for a single vector (N,)."""
    return spmm(A, u[:, None])[:, 0]


def spmm_gram(A, U: torch.Tensor):
    """(A @ U, U^T A U): one fused kernel pass for the banded, rolling and
    split formats, the kernel plus an fp32 matmul epilogue for strip-BSR,
    the two-pass form for other formats."""
    if isinstance(A, BandedELL):
        return banded_spmm_gram(A, U)
    if isinstance(A, RollingBanded):
        return rolling_spmm_gram(A, U)
    if isinstance(A, SplitBanded):
        return split_spmm_gram(A, U)
    if isinstance(A, BSRTile):
        return bsr_spmm_gram(A, U)
    W = spmm(A, U)
    return W, node_reduce(A, gram(U, W))


def gram(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """U^T V (k x k), full f32."""
    return hdot(U.T, V)


def m_gram(U: torch.Tensor, M) -> torch.Tensor:
    """U^T M U — the M-inner-product Gram matrix."""
    return node_reduce(M, gram(U, spmm(M, U)))


def rayleigh_quotients(U: torch.Tensor, K, M,
                       eps: float = 1e-12) -> torch.Tensor:
    """Per-mode Rayleigh quotients diag(U^T K U) / diag(U^T M U)."""
    Ku = spmm(K, U)
    Mu = spmm(M, U)
    return (node_reduce(M, (U * Ku).sum(0))
            / (node_reduce(M, (U * Mu).sum(0)) + eps))


def m_normalize_columns(U: torch.Tensor, M,
                        eps: float = 1e-12) -> torch.Tensor:
    """Normalize each column to unit M-norm."""
    Mu = spmm(M, U)
    return U / torch.sqrt(node_reduce(M, (U * Mu).sum(0)) + eps)[None, :]


def normalize_columns(U: torch.Tensor, eps: float = 1e-12):
    """Euclidean column normalization (src/utils.py:23-32); returns
    (U / norms, norms)."""
    norms = torch.linalg.norm(U, dim=0) + eps
    return U / norms, norms


def residual(U: torch.Tensor, K, M, lam: torch.Tensor) -> torch.Tensor:
    """Eigen-residual K U - M U diag(lam), shape (N, k)."""
    return spmm(K, U) - spmm(M, U) * lam[None, :]


def _block_diag_layout(mats: list):
    """(indices, values, n_cols) of the block-diagonal stack of SparseELL
    blocks: widths padded to the widest, columns offset by the blocks
    before, and every zero entry (padding included) pointed at its
    block's first column, so that no block gathers outside its span."""
    width = max(A.indices.shape[1] for A in mats)
    idx_blocks, val_blocks = [], []
    offset = 0
    for A in mats:
        pad = width - A.indices.shape[1]
        idx = torch.nn.functional.pad(A.indices, (0, pad)) + offset
        val = torch.nn.functional.pad(A.values, (0, pad))
        idx_blocks.append(torch.where(val != 0, idx,
                                      torch.full_like(idx, offset)))
        val_blocks.append(val)
        offset += A.n_cols
    return torch.cat(idx_blocks), torch.cat(val_blocks), offset


def block_diag_ell(ops: list) -> SparseELL:
    """Stack per-level operators (Diagonal or SparseELL) into one
    block-diagonal SparseELL, the analog of `utils.sparse_block_diag`
    (src/utils.py:127-165): all levels share one SpMM over the
    concatenated node axis. A Diagonal level enters as a width-1 ELL
    block. The layout is the JAX package's entry for entry; when a level
    carries a stored transpose, the stack carries the block-diagonal
    stack of the levels' transposes (a symmetric level is its own)."""
    mats = []
    for A in ops:
        if isinstance(A, Diagonal):
            n = A.diag.shape[0]
            A = SparseELL(torch.arange(n, device=A.diag.device)[:, None],
                          A.diag[:, None], n)
        elif not isinstance(A, SparseELL):
            raise TypeError(f"block_diag_ell stacks Diagonal and SparseELL "
                            f"operators, got {type(A)}")
        mats.append(A)
    transpose = None
    if any(A.transpose_ell is not None for A in mats):
        transpose = SparseELL(*_block_diag_layout(
            [A.transpose_ell if A.transpose_ell is not None else A
             for A in mats]))
    return SparseELL(*_block_diag_layout(mats), transpose)


def gcn_normalized_adjacency(edge_index, n_nodes: int, device="cuda",
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


def neighbor_mean(edge_index, x: torch.Tensor) -> torch.Tensor:
    """Mean over in-neighbors: agg[i] = mean_{(i,j) in E} x[j], a segment
    sum (`index_add_`) over the edges' rows divided by the in-degree
    clamped at 1 (src/corrector_model.py:23-31). `edge_index` is (2, E),
    a tensor or an array. Training loops prefer `neighbor_mean_operator`
    + `spmm`, whose forward and backward are both gathers."""
    e = torch.as_tensor(np.asarray(edge_index) if not isinstance(
        edge_index, torch.Tensor) else edge_index, device=x.device)
    row, col = e[0].long(), e[1].long()
    n = x.shape[0]
    agg = x.new_zeros((n,) + tuple(x.shape[1:])).index_add_(0, row, x[col])
    deg = x.new_zeros(n).index_add_(0, row, x.new_ones(row.shape[0]))
    return agg / torch.clamp(deg, min=1.0)[:, None]


def neighbor_mean_scipy(edge_index, n_nodes: int):
    """The mean-aggregation matrix D^{-1} A as scipy CSR."""
    e = np.asarray(edge_index)
    A = sp.coo_matrix((np.ones(e.shape[1]), (e[0], e[1])),
                      shape=(n_nodes, n_nodes)).tocsr()
    A.sum_duplicates()
    deg = np.asarray(A.sum(axis=1)).ravel()
    return (sp.diags(1.0 / np.clip(deg, 1.0, None)) @ A).tocsr()


def neighbor_mean_operator(edge_index, n_nodes: int, device="cuda",
                           dtype=torch.float32) -> SparseELL:
    """D^{-1} A as SparseELL with its transpose attached:
    `spmm(op, x)[i]` is the mean of x over i's out-neighbors."""
    return SparseELL.from_scipy(neighbor_mean_scipy(edge_index, n_nodes),
                                dtype=dtype, device=device)
