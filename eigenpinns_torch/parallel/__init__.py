"""The multi-device path: process-group meshes, sharded SpMMs and their
collectives (SPMD, one process per device). Port of
`eigenpinns_tpu/parallel/`."""

from eigenpinns_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    node_sharding,
    pad_to_multiple,
    replicated,
    shard_array,
    spawn,
)
from eigenpinns_torch.parallel.data_parallel import constrain, make_dp_train_step
from eigenpinns_torch.parallel.sharded import (
    ShardedOperator,
    all_gather,
    all_gather_spmm,
    average_gradients,
    gather_rows,
    halo_spmm,
    pad_rows,
    psum,
    psum_gram,
    ring_exchange,
)
from eigenpinns_torch.parallel.sharded_banded import (
    ShardedBanded,
    ShardedRemainder,
    build_sharded_operator,
    sharded_banded_spmm,
    sharded_split_spmm,
)

__all__ = [
    "Mesh", "make_mesh", "node_sharding", "replicated", "pad_to_multiple",
    "shard_array", "spawn", "make_dp_train_step", "constrain",
    "ShardedOperator", "all_gather_spmm", "halo_spmm", "psum_gram",
    "pad_rows", "psum", "all_gather", "ring_exchange", "average_gradients",
    "gather_rows",
    "ShardedBanded", "ShardedRemainder", "build_sharded_operator",
    "sharded_banded_spmm", "sharded_split_spmm",
]
