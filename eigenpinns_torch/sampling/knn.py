"""kNN graphs and prolongation operators (host-side).

Replaces the reference's sklearn NearestNeighbors paths
(`utils.build_knn_graph` src/utils.py:63-75 and `utils.build_prolongation`
src/utils.py:39-60). A copy of the host paths of
`eigenpinns_tpu/sampling/knn.py`: the kNN graph takes the compiled kernel
of `geometry/native.py` when its library loads, else scipy's cKDTree.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
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
