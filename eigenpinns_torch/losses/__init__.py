from eigenpinns_torch.losses.losses import (
    eigenvalue_target,
    ordering,
    projection,
    rayleigh_residual_orth,
    trace_loss,
    zero_mean,
)

__all__ = ["rayleigh_residual_orth", "trace_loss", "ordering",
           "eigenvalue_target", "zero_mean", "projection"]
