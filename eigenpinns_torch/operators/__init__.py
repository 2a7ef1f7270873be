from eigenpinns_torch.operators.eikonal import (
    eigen_positional_encoding,
    eikonal_residual,
    gradient_norm_operator,
)
from eigenpinns_torch.operators.schrodinger import (
    harmonic_oscillator,
    hutchinson_laplacian,
    infinite_well,
    laplacian_nd,
    mc_inner,
    mc_norm_sq,
    oscillator_eigenvalues,
    schrodinger_residual,
    second_derivative_1d,
    well_eigenvalues,
)

__all__ = [
    "infinite_well", "harmonic_oscillator", "well_eigenvalues",
    "oscillator_eigenvalues", "second_derivative_1d", "laplacian_nd",
    "schrodinger_residual", "mc_norm_sq", "mc_inner", "hutchinson_laplacian",
    "gradient_norm_operator", "eikonal_residual", "eigen_positional_encoding",
]
