"""kNN graphs and prolongation operators (host-side).

Replaces the reference's sklearn NearestNeighbors paths
(`utils.build_knn_graph` src/utils.py:63-75 and `utils.build_prolongation`
src/utils.py:39-60). A copy of the host paths of
`eigenpinns_tpu/sampling/knn.py`: the kNN graph takes the compiled kernel
of `geometry/native.py` when its library loads, else scipy's cKDTree.
`knn_graph_device` ports the JAX package's on-device brute-force kNN.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from scipy.spatial import cKDTree

from eigenpinns_torch.geometry import native as _native


def knn_graph(X: np.ndarray, k: int) -> np.ndarray:
    """(2, N*k) directed edge index: row i -> each of its k nearest
    neighbors (self excluded) — semantics of src/utils.py:63-75."""
    n = X.shape[0]
    k = min(k, n - 1)
    if _native.available():
        cols = _native.knn_native(np.asarray(X, np.float64), k).reshape(-1)
    else:
        _, idx = cKDTree(X).query(X, k=k + 1)
        cols = idx[:, 1:].reshape(-1)
    rows = np.repeat(np.arange(n), k)
    return np.stack([rows, cols]).astype(np.int64)


def prolongation_matrix(X_coarse: np.ndarray, X_fine: np.ndarray,
                        k: int) -> sp.coo_matrix:
    """(n_fine, n_coarse) inverse-distance kNN interpolation weights —
    semantics of src/utils.py:39-60 (weights 1/(d+1e-12), row-normalized)."""
    k = min(k, X_coarse.shape[0])
    tree = cKDTree(X_coarse)
    dist, idx = tree.query(X_fine, k=k)
    if k == 1:
        dist, idx = dist[:, None], idx[:, None]
    w = 1.0 / (dist + 1e-12)
    w /= w.sum(axis=1, keepdims=True)
    n_fine = X_fine.shape[0]
    rows = np.repeat(np.arange(n_fine), k)
    return sp.coo_matrix(
        (w.reshape(-1), (rows, idx.reshape(-1))),
        shape=(n_fine, X_coarse.shape[0]),
    )


def knn_graph_device(X, k: int, device="cuda") -> torch.Tensor:
    """On-device brute-force kNN: pairwise squared distances in full fp32
    (TF32 off) and `torch.topk`; the (2, N*k) edge layout of `knn_graph`.

    O(N^2) work and memory (the (N, N) distance matrix is 14.4 GB at
    60k points): the JAX docstring sets its range at <= 100k points. The
    diagonal is masked to +inf with `torch.where` (0 * inf would be nan).
    Neighbors come nearest first. The formula cancels: a squared distance
    is off by up to ~4 eps_fp32 (|x_i|^2 + |x_j|^2), so a row whose k-th
    and (k+1)-th neighbors are closer than that may list the other one
    (and ties may order differently) than the host's float64 graph.
    """
    X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=device)
    n = X.shape[0]
    sq = torch.sum(X * X, dim=1)
    # (|x_i|^2 + |x_j|^2) - 2 x_i.x_j, as the JAX function sums it, in
    # one GEMM epilogue (the scaling by -2 is exact).
    d2 = torch.addmm(sq[:, None] + sq[None, :], X, X.T, alpha=-2.0)
    ar = torch.arange(n, device=device)
    d2 = torch.where(ar[:, None] == ar[None, :], torch.inf, d2)
    idx = torch.topk(d2, k, dim=1, largest=False).indices
    return torch.stack([ar.repeat_interleave(k), idx.reshape(-1)])
