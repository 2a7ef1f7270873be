"""Comprehensive post-training diagnostics vs the classical oracle.

Parity with `diagnostics.comprehensive_diagnostics`
(src/diagnostics.py:117-257): recompute the exact solution on the same
discretization, align modes, report per-mode eigenvalue errors, M-cosine
similarity, Procrustes subspace error and orthonormality, and save the
2x2 diagnostic plot. A copy of `eigenpinns_tpu/diagnostics/report.py`;
matplotlib is imported only when a plot is asked for, and its
ImportError then propagates.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from eigenpinns_torch.diagnostics.alignment import (
    align_eigenvectors,
    m_cosine_similarity,
    orthonormality_error,
    procrustes_subspace_error,
    rayleigh_quotients,
)


@dataclasses.dataclass
class DiagnosticsReport:
    lambda_exact: np.ndarray
    lambda_pred: np.ndarray
    abs_errors: np.ndarray
    rel_errors: np.ndarray
    cosine_similarity: np.ndarray
    subspace_error: float
    orthonormality: float

    def summary(self) -> str:
        lines = [
            "=" * 72,
            "COMPREHENSIVE DIAGNOSTICS",
            "=" * 72,
            f"{'mode':>4} {'lam_exact':>12} {'lam_pred':>12} "
            f"{'abs_err':>10} {'rel_err':>10} {'|cos|':>8}",
        ]
        for i in range(len(self.lambda_exact)):
            lines.append(
                f"{i:>4} {self.lambda_exact[i]:>12.6f} "
                f"{self.lambda_pred[i]:>12.6f} {self.abs_errors[i]:>10.2e} "
                f"{self.rel_errors[i]:>10.2%} "
                f"{self.cosine_similarity[i]:>8.4f}")
        lines += [
            "-" * 72,
            f"mean rel err (modes 1+): {self.rel_errors[1:].mean():.3%}",
            f"Procrustes subspace error: {self.subspace_error:.4e}",
            f"max |U^T M U - I|: {self.orthonormality:.4e}",
            "=" * 72,
        ]
        return "\n".join(lines)


def comprehensive_diagnostics(
    U_pred: np.ndarray,
    K,
    M,
    n_modes: int | None = None,
    exact: tuple | None = None,
    plot_path: str | None = None,
    verbose: bool = True,
) -> DiagnosticsReport:
    """Evaluate predictions against the eigsh oracle on (K, M).

    `exact` may pass a precomputed (vals, vecs) pair; otherwise ARPACK
    recomputes it (the reference recomputes every run,
    src/diagnostics.py:130-138).
    """
    from eigenpinns_torch.solvers.oracle import eigsh_smallest

    k = n_modes or U_pred.shape[1]
    U_pred = np.asarray(U_pred[:, :k], dtype=np.float64)
    if exact is None:
        vals_exact, vecs_exact = eigsh_smallest(K, M, k)
    else:
        vals_exact, vecs_exact = exact
    U_aligned, perm, _, _ = align_eigenvectors(U_pred, vecs_exact, M)
    lam_pred = rayleigh_quotients(U_aligned, K, M)
    abs_err = np.abs(lam_pred - vals_exact)
    rel_err = abs_err / np.maximum(np.abs(vals_exact), 1e-12)
    cos = m_cosine_similarity(U_aligned, vecs_exact, M)
    sub_err, _ = procrustes_subspace_error(U_aligned, vecs_exact, M)
    orth = orthonormality_error(U_aligned, M)
    report = DiagnosticsReport(vals_exact, lam_pred, abs_err, rel_err, cos,
                               sub_err, orth)
    if verbose:
        print(report.summary())
    if plot_path:
        _plot(report, U_aligned, plot_path)
    return report


def _plot(report: DiagnosticsReport, U_pred, path: str) -> None:
    """2x2 diagnostic figure (src/diagnostics.py:260-297)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(12, 10))
    k = len(report.lambda_exact)
    modes = np.arange(k)

    ax = axes[0, 0]
    ax.plot(modes, report.lambda_exact, "o-", label="exact")
    ax.plot(modes, report.lambda_pred, "x--", label="predicted")
    ax.set_title("Eigenvalue spectrum")
    ax.set_xlabel("mode")
    ax.legend()

    ax = axes[0, 1]
    ax.semilogy(modes[1:], np.maximum(report.rel_errors[1:], 1e-16), "s-")
    ax.set_title("Relative eigenvalue error")
    ax.set_xlabel("mode")

    ax = axes[1, 0]
    ax.bar(modes, report.cosine_similarity)
    ax.set_ylim(0, 1.05)
    ax.set_title("M-cosine similarity")
    ax.set_xlabel("mode")

    ax = axes[1, 1]
    G = U_pred.T @ U_pred  # plain Gram as structure visual
    im = ax.imshow(np.abs(G), cmap="viridis")
    ax.set_title("|U_pred^T U_pred|")
    fig.colorbar(im, ax=ax)

    fig.tight_layout()
    import os

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    fig.savefig(path, dpi=100)
    plt.close(fig)
