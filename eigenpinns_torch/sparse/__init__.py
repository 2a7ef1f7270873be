from eigenpinns_torch.sparse.banded import (
    BandedELL,
    banded_spmm,
    banded_spmm_cuda,
    banded_spmm_gram,
    banded_spmm_gram_plain,
    banded_spmm_hbm_bytes,
    banded_spmm_plain,
)
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
from eigenpinns_torch.sparse.occupancy import occupancy_mask, occupied_blocks
from eigenpinns_torch.sparse.ops import (
    FunctionOperator,
    block_diag_ell,
    gcn_normalized_adjacency,
    gram,
    hdot,
    m_gram,
    m_normalize_columns,
    neighbor_mean,
    neighbor_mean_operator,
    node_reduce,
    normalize_columns,
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
from eigenpinns_torch.sparse.split import (
    SplitBanded,
    hilbert_order,
    spatial_cluster_order,
    split_spmm,
    split_spmm_gram,
)

__all__ = [
    "Diagonal", "SparseELL", "as_operator", "RollingBanded", "BSRTile",
    "BandedELL", "SplitBanded", "hilbert_order", "spatial_cluster_order",
    "banded_spmm", "banded_spmm_gram", "banded_spmm_cuda",
    "banded_spmm_plain", "banded_spmm_gram_plain", "banded_spmm_hbm_bytes",
    "split_spmm", "split_spmm_gram",
    "bsr_spmm", "bsr_spmm_gram", "bsr_spmm_grouped_cuda",
    "bsr_spmm_burst_cuda", "bsr_spmm_plain", "bsr_spmm_hbm_bytes",
    "rolling_spmm", "rolling_spmm_gram", "rolling_spmm_cuda",
    "rolling_spmm_plain", "rolling_spmm_gram_plain",
    "gcn_normalized_adjacency", "gram", "hdot", "m_gram",
    "m_normalize_columns", "neighbor_mean_operator", "rayleigh_quotients",
    "block_diag_ell", "neighbor_mean", "normalize_columns",
    "FunctionOperator", "node_reduce",
    "residual", "spmm", "spmm_gram", "spmv",
    "occupancy_mask", "occupied_blocks",
]
