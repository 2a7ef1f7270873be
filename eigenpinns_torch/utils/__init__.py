from eigenpinns_torch.utils.fixtures import (
    align_ritz_vectors,
    generate_test_matrices,
    icosphere,
    laplacian_1d,
    laplacian_1d_eigenvalues,
    perturbed_icosphere,
    random_spd,
    subsample_hierarchy,
    tridiagonal,
    verify_eigenpairs,
)
from eigenpinns_torch.utils.profiling import PhaseTimer, annotate, trace

__all__ = ["align_ritz_vectors", "icosphere", "perturbed_icosphere", "laplacian_1d",
           "laplacian_1d_eigenvalues", "tridiagonal", "random_spd",
           "generate_test_matrices", "verify_eigenpairs",
           "subsample_hierarchy", "PhaseTimer", "annotate", "trace"]
