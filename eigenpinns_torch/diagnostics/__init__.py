from eigenpinns_torch.diagnostics.alignment import (
    align_eigenvectors,
    procrustes_subspace_error,
    rayleigh_quotients,
    orthonormality_error,
    m_cosine_similarity,
)
from eigenpinns_torch.diagnostics.report import (
    DiagnosticsReport,
    comprehensive_diagnostics,
)
from eigenpinns_torch.diagnostics.visualize import (
    plot_mesh,
    plot_hierarchy_levels,
    plot_eigenfunctions,
    plot_loss_history,
)

__all__ = [
    "align_eigenvectors", "procrustes_subspace_error", "rayleigh_quotients",
    "orthonormality_error", "m_cosine_similarity",
    "DiagnosticsReport", "comprehensive_diagnostics",
    "plot_mesh", "plot_hierarchy_levels", "plot_eigenfunctions",
    "plot_loss_history",
]
