from eigenpinns_torch.sparse.bsr import (
    BSRTile,
    bsr_spmm,
    bsr_spmm_burst_cuda,
    bsr_spmm_gram,
    bsr_spmm_grouped_cuda,
    bsr_spmm_hbm_bytes,
    bsr_spmm_plain,
)
from eigenpinns_torch.sparse.formats import Diagonal, SparseELL, as_operator
from eigenpinns_torch.sparse.ops import (
    gcn_normalized_adjacency,
    gram,
    hdot,
    m_gram,
    m_normalize_columns,
    neighbor_mean_operator,
    rayleigh_quotients,
    residual,
    spmm,
    spmm_gram,
    spmv,
)
from eigenpinns_torch.sparse.rolling import (
    RollingBanded,
    rolling_spmm,
    rolling_spmm_cuda,
    rolling_spmm_gram,
    rolling_spmm_gram_plain,
    rolling_spmm_plain,
)

__all__ = [
    "Diagonal", "SparseELL", "as_operator", "RollingBanded", "BSRTile",
    "bsr_spmm", "bsr_spmm_gram", "bsr_spmm_grouped_cuda",
    "bsr_spmm_burst_cuda", "bsr_spmm_plain", "bsr_spmm_hbm_bytes",
    "rolling_spmm", "rolling_spmm_gram", "rolling_spmm_cuda",
    "rolling_spmm_plain", "rolling_spmm_gram_plain",
    "gcn_normalized_adjacency", "gram", "hdot", "m_gram",
    "m_normalize_columns", "neighbor_mean_operator", "rayleigh_quotients",
    "residual", "spmm", "spmm_gram", "spmv",
]
