from eigenpinns_torch.losses.losses import (
    deflation,
    diversity,
    eigenvalue_target,
    gram_orthogonality,
    normalization,
    ordering,
    projection,
    rayleigh_and_residual,
    rayleigh_residual_orth,
    smoothness,
    trace_loss,
    zero_lambda,
    zero_mean,
)
from eigenpinns_torch.losses.whitening import (
    gram_condition_penalty,
    newton_schulz_inv_sqrt,
    newton_schulz_orthonormalize,
    spectral_orthonormalize,
)

__all__ = ["rayleigh_residual_orth", "rayleigh_and_residual",
           "gram_orthogonality", "normalization", "deflation", "trace_loss",
           "ordering", "eigenvalue_target", "zero_mean", "zero_lambda",
           "diversity", "smoothness", "projection",
           "newton_schulz_inv_sqrt", "newton_schulz_orthonormalize",
           "spectral_orthonormalize", "gram_condition_penalty"]
