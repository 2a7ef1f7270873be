"""Mode alignment and subspace comparison utilities.

Parity with `src/diagnostics.py:12-114`: Hungarian matching of predicted
modes to exact modes via |U_pred^T M U_exact| overlaps with sign fixing,
Procrustes subspace error via SVD, and Rayleigh-quotient extraction.
Host-side numpy/scipy: diagnostics are offline, k <= 128.

A copy of `eigenpinns_tpu/diagnostics/alignment.py`.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def align_eigenvectors(U_pred: np.ndarray, U_exact: np.ndarray, M):
    """Match predicted modes to exact modes (Hungarian on -|overlap|) and
    fix signs (src/diagnostics.py:12-70).

    Returns (U_aligned, permutation, signs, overlap_matrix).
    """
    W = np.abs(U_pred.T @ (M @ U_exact))  # (k, k) overlap magnitudes
    row, col = linear_sum_assignment(-W)
    perm = np.empty_like(col)
    perm[col] = row
    U_aligned = U_pred[:, perm]
    signs = np.sign(
        np.sum(U_aligned * (M @ U_exact), axis=0))
    signs[signs == 0] = 1.0
    return U_aligned * signs[None, :], perm, signs, W


def procrustes_subspace_error(U_pred: np.ndarray, U_exact: np.ndarray, M):
    """Optimal-rotation subspace distance (src/diagnostics.py:73-100):
    W = U_pred^T M U_exact, R = V D^T from its SVD, error =
    ||U_pred R - U_exact||_F / ||U_exact||_F."""
    W = U_pred.T @ (M @ U_exact)
    V, _, Dt = np.linalg.svd(W)
    R = V @ Dt
    err = np.linalg.norm(U_pred @ R - U_exact) / np.linalg.norm(U_exact)
    return err, R


def rayleigh_quotients(U: np.ndarray, K, M) -> np.ndarray:
    """Per-mode Rayleigh quotients (src/diagnostics.py:107-114)."""
    num = np.sum(U * (K @ U), axis=0)
    den = np.sum(U * (M @ U), axis=0)
    return num / (den + 1e-300)


def orthonormality_error(U: np.ndarray, M) -> float:
    """max |U^T M U - I| (src/diagnostics.py:240-249)."""
    G = U.T @ (M @ U)
    return float(np.abs(G - np.eye(U.shape[1])).max())


def m_cosine_similarity(U_pred: np.ndarray, U_exact: np.ndarray,
                        M) -> np.ndarray:
    """Per-mode |cos| in the M-inner product (src/diagnostics.py:197-229)."""
    num = np.abs(np.sum(U_pred * (M @ U_exact), axis=0))
    den = (np.sqrt(np.sum(U_pred * (M @ U_pred), axis=0))
           * np.sqrt(np.sum(U_exact * (M @ U_exact), axis=0)))
    return num / (den + 1e-300)
