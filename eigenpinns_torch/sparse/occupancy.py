"""Occupancy tables of the dense tile layouts: which 16 x 16 sub-blocks
of each 128 x 128 piece hold a nonzero.

The strip-BSR strips (`BSRTile.data`), the full-window band
(`BandedELL.band`) and the rolling band (`RollingBanded.band`) are dense
and mostly zero: on a 300k-point cloud Laplacian 13-22% of the 16 x 16
sub-blocks of the first two hold anything, 4% of the rolling band's.
The CUDA kernels of `csrc/bsr_spmm.cu` and `csrc/banded_spmm.cu` walk
this table and read and multiply only the occupied sub-blocks; the
stored layout itself is unchanged.

One int64 word per 128 x 128 piece: bit 8 i + j is set when the
sub-block of rows [16 i, 16 i + 16) and columns [16 j, 16 j + 16) of the
piece holds a nonzero, so byte i of the word (little-endian) is the
column-group mask of row stripe i. For strip-BSR the pieces are the
(chunk, slot) tiles, shape (S, C); for the bands they are the 128-column
pieces of each row tile's (rotated, for the rolling band) columns, shape
(n_pad / 128, B / 128).

The table is derived from the dense tensor on its device, so it cannot
disagree with the data. A set bit over an all-zero sub-block is harmless
(the kernel multiplies zeros); a clear bit over a nonzero would be a
wrong product.
"""

from __future__ import annotations

import torch

PIECE = 128   # edge of the piece one word describes
SUB = 16      # edge of a sub-block; PIECE / SUB = 8 bits per byte


def occupancy_mask(dense: torch.Tensor) -> torch.Tensor:
    """The (R, Q) int64 occupancy table of a (R*128, Q*128) dense tensor,
    computed on its device."""
    rows, cols = dense.shape
    if rows % PIECE or cols % PIECE:
        raise ValueError("occupancy_mask needs both extents to be "
                         f"multiples of {PIECE}, got {tuple(dense.shape)}")
    R, Q, s = rows // PIECE, cols // PIECE, PIECE // SUB
    occ = dense.view(R, s, SUB, Q, s, SUB).ne(0).any(dim=5).any(dim=2)
    # (R, i, Q, j) -> (R, Q, 8 i + j); bit 63 is int64's sign bit.
    bits = occ.permute(0, 2, 1, 3).reshape(R, Q, s * s).to(torch.int64)
    weights = torch.tensor([1 << b for b in range(63)] + [-(1 << 63)],
                           dtype=torch.int64, device=dense.device)
    return (bits * weights).sum(dim=2)


def occupied_blocks(mask: torch.Tensor) -> int:
    """Number of set bits (occupied 16 x 16 sub-blocks) of a table."""
    shifts = torch.arange(64, device=mask.device)
    return int(((mask.unsqueeze(-1) >> shifts) & 1).sum())


def default_col_block(k: int, dtype: torch.dtype) -> int:
    """Output columns one block of the occupancy-driven kernels owns, 32
    or 64, for a product of width k on data of `dtype`: the faster of the
    two on an NVIDIA H100 80GB HBM3 (700 W) at k = 20, 28, 60 and 128 on
    the 300k-point cloud's operators (chip_smoke.py prints both times).
    fp32 data: 32 up to k = 32 (a lane per column), else 64 (two columns
    per lane: one pass over the sub-blocks serves 64 columns, and each
    shared-memory load of the data feeds twice the FFMA). bf16 data: 32
    always (the tensor-core path keeps a 16 x 32 block in 16 registers a
    lane; at 64 its registers double and fewer warps hide the loads).

    The strip-BSR kernels start from it but do not always take it
    (`sparse/bsr.py`): on fp32 strips at k <= 8 they take the narrow
    path, one lane a row over the operator's nonzeros, and no column
    block (at k = 1 on the 300k K 0.0088 ms on the card, against 0.2018
    for the walk); on an operator whose row tiles x column blocks give
    fewer than two blocks an SM (CLI run B's K_blk: 35 row tiles) they
    take 32 columns and blocks of 4 or 2 warps (at k = 64 in fp32 0.0162
    ms, against 0.0203 at 64 columns on 8-warp blocks). The same bits
    either way; NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py's Dirichlet
    and CLI phases."""
    return 64 if dtype == torch.float32 and k > 32 else 32
