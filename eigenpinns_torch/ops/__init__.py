"""Compute-op namespace: re-exports the port's operator kernels.

The port of `eigenpinns_tpu/ops/__init__.py`. The op surface lives in two
implementation packages -- `sparse/` (operator formats and the SpMM and
Gram kernels, the hand-written CUDA ones included) and `operators/`
(problem definitions: the Schrodinger and eikonal residuals; the
Laplace-Beltrami assembly lives in `geometry/`). This module gathers them
under one import:

    from eigenpinns_torch.ops import spmm, banded_spmm, schrodinger_residual

The JAX package's `banded_spmm_pallas` and `banded_spmm_reference` are
`banded_spmm_cuda` and `banded_spmm_plain` here.
"""

from eigenpinns_torch.operators import (  # noqa: F401
    eigen_positional_encoding,
    eikonal_residual,
    gradient_norm_operator,
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
from eigenpinns_torch.sparse import (  # noqa: F401
    BandedELL,
    BSRTile,
    Diagonal,
    RollingBanded,
    SparseELL,
    SplitBanded,
    as_operator,
    banded_spmm,
    banded_spmm_cuda,
    banded_spmm_gram,
    banded_spmm_plain,
    block_diag_ell,
    bsr_spmm,
    bsr_spmm_gram,
    gcn_normalized_adjacency,
    gram,
    hdot,
    m_gram,
    m_normalize_columns,
    neighbor_mean,
    neighbor_mean_operator,
    normalize_columns,
    rayleigh_quotients,
    residual,
    rolling_spmm,
    spmm,
    spmm_gram,
    spmv,
)
