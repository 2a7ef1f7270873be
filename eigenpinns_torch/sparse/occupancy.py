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

import functools

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


@functools.cache
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the card holding `device`."""
    return torch.cuda.get_device_properties(device).multi_processor_count


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
    and CLI phases.

    The band kernels start from it too (`band_grid`): on an fp32 band a
    product that fits one column block (k <= col_block) takes the staged
    route, whose blocks own every column and stage each piece's U groups
    once for all their stripes, on 8-, 4- or 2-warp blocks by the same
    fill rule as strip-BSR's small grid."""
    return 64 if dtype == torch.float32 and k > 32 else 32


BAND_ROUTES = ("staged", "walk")


def band_grid(n_tiles: int, k: int, dtype: torch.dtype, sms: int,
              with_gram: bool = False, col_block: int | None = None,
              warps: int | None = None,
              route: str | None = None) -> tuple[str, int, int]:
    """(route, col_block, warps) of one launch of the band kernels
    (`csrc/banded_spmm.cu`) on a band of `n_tiles` 128-row tiles, for a
    product of width k on a card of `sms` SMs.

    `col_block` defaults to `default_col_block(k, dtype)`. The staged
    route takes an fp32 band whose product fits one column block (k <=
    col_block): each block owns every column of `warps` of a tile's 8
    stripes and stages the U groups of each piece once, for all of
    them, by asynchronous copies. Its blocks hold 8 stripes, or, when
    the tiles give fewer than two blocks an SM, the most of 4 or 2 that
    give two (K_blk's 34 tiles on 132 SMs: 136 blocks of 2). The Gram
    takes whole tiles, so 8, and on such a small operator at 32 columns
    the walk, which is faster there: K_blk at k = 10 with the Gram
    0.0219 ms on the card against the walk's 0.0204, the CLI's FEM
    K_blk 0.0212 against 0.0201, where at 64 columns (K_finest, k = 39)
    the staged Gram wins, 0.0278 against 0.0286, as on the 300k cluster
    core, 0.3431 against 0.3587 at k = 60 (NVIDIA H100 80GB HBM3, 700
    W, chip_smoke.py's `[route]` lines). Anything else (a bf16 band, or
    k past the column block: k = 84 and 128 run two blocks of 64
    columns) takes the column-block walk, 8 stripes a block, one column
    block each. Every choice sums each output in the same order, so W
    has the same bits.
    `warps` and `route` force a choice (the card tests and
    chip_smoke.py use them); one the kernels cannot take raises."""
    if col_block is None:
        col_block = default_col_block(k, dtype)
    if col_block not in (32, 64):
        raise ValueError(f"col_block must be 32 or 64, got {col_block}")
    can_stage = dtype == torch.float32 and k <= col_block
    small = n_tiles < 2 * sms
    if route is None:
        route = ("staged" if can_stage and not (
            with_gram and small and col_block == 32) else "walk")
    if route not in BAND_ROUTES:
        raise ValueError(f"route must be one of {BAND_ROUTES}, got {route!r}")
    if route == "staged" and not can_stage:
        raise ValueError("the staged route takes an fp32 band and k <= "
                         f"col_block (got {dtype}, k = {k}, col_block "
                         f"{col_block})")
    if warps is None:
        warps = (8 if route == "walk" or with_gram or not small
                 else 4 if n_tiles >= sms else 2)
    if warps not in (8, 4, 2) or (warps != 8 and (route == "walk"
                                                  or with_gram)):
        raise ValueError("blocks hold 8, 4 or 2 stripes on the staged "
                         f"route without the Gram, 8 otherwise (got {warps}"
                         f" on the {route} route, with_gram={with_gram})")
    return route, col_block, warps
