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
    for the walk), and up to k = 128 the row-wise route over the same
    table (at k = 84 on the 1M K 0.5878 ms against the walk's 1.5427,
    polish_products.py); past it, or on bf16 strips, on an operator whose
    row tiles x column blocks give fewer than two blocks an SM (CLI run
    B's K_blk: 35 row tiles) the walk takes 32 columns and blocks of 4
    or 2 warps (at k = 64 in fp32 0.0162 ms, against 0.0203 at 64
    columns on 8-warp blocks). The same bits either way; NVIDIA H100
    80GB HBM3, 700 W, chip_smoke.py's Dirichlet and CLI phases.

    The band kernels start from it too (`band_grid`): on an fp32 band a
    product that fits one column block (k <= col_block) takes the staged
    route, whose blocks own every column and stage each piece's U groups
    once for all their stripes, on 8-, 4- or 2-warp blocks by the same
    fill rule as strip-BSR's small grid, unless the band carries a
    nonzero table, whose row-wise route takes no column block."""
    return 64 if dtype == torch.float32 and k > 32 else 32


BAND_ROUTES = ("staged", "walk", "rows")

# Widths at which an fp32 rolling band with a nonzero table
# (`RollingBanded.narrow`) takes the row-wise route by default, without
# the Gram: on the 300k rolling band it beats the staged route and the
# walk at k = 20, 28, 60, 84 and 128 (0.0452 / 0.1458, 0.0750 / 0.1498,
# 0.1415 / 0.1986, 0.1812 / 0.4646, 0.2692 / 0.4680 ms on the card,
# NVIDIA H100 80GB HBM3, 700.00 W, polish_products.py), as the strip-BSR
# route does from k = 9 (`bsr.strip_route`).
BAND_ROWS_K = (9, 128)

# The same for a bf16 rolling band (its table's values rounded,
# `RollingBanded.with_precision`): the bf16 row-wise route beats the
# tensor-core walk on the 300k rolling band at k = 12, 20, 28, 60 and 84
# (0.0353 / 0.1029, 0.0514 / 0.1143, 0.0700 / 0.1318, 0.1374 / 0.2522,
# 0.1810 / 0.3512 ms on the card, NVIDIA H100 80GB HBM3, 700.00 W,
# polish_products.py --gram).
BAND_BF16_ROWS_K = (12, 84)

# Widths at which a rolling band with its table takes the row-wise route
# with the Gram by default (the partials in the product's blocks, then
# the walk's reduce), by the band's type, against the route it replaced
# (polish_products.py --gram, as above). fp32: the multigrid K_blk and
# the transfer path's level operators at k = 10 (0.0095-0.0099 /
# 0.0132-0.0205 ms, the walk), the 300k rolling band at k = 10 and 20
# (0.0528 / 0.2116, 0.0741 / 0.2201, the staged route; at k = 28 and 39,
# which no path launches with the Gram, 0.1111 / 0.2284 and 0.1878 /
# 0.3088). bf16: the 300k rolling band at k = 20 and 28 (0.0973 /
# 0.1566, 0.1308 / 0.1821, the walk).
BAND_GRAM_ROWS_K = {torch.float32: (10, 20), torch.bfloat16: (20, 28)}

# Widths at which a full-window band with its nonzero table
# (`BandedELL.narrow`) takes the row-wise route by default, without the
# Gram, by the band's type: the span of the widths at which it beats the
# route it replaces on the paths' operators (on the card, NVIDIA H100
# 80GB HBM3, 700.00 W). fp32, against the staged route (the walk at 84):
# the 300k Hilbert core (window 512) at k = 20, 28, 84 0.0444 / 0.1022,
# 0.0739 / 0.1040, 0.1826 / 0.3460 ms (polish_products.py --tables); the
# 300k and 1M cluster cores (window 1024) at k = 20 0.0451 / 0.1303 and
# 0.1375 / 0.4110, at k = 60 0.1435 / 0.1641 and 0.4659 / 0.5304
# (chip_smoke.py); the sharded paths' shard blocks and transposes (their
# tables since PR 16): 16c's 75008 x 82432 block at k = 20, 28, 60, 84
# 0.0104 / 0.0518, 0.0149 / 0.0549, 0.0396 / 0.0681, 0.0492 / 0.1321, the
# 1M split core at one shard (16b) 0.1377 / 0.4065, 0.2364 / 0.4086,
# 0.4657 / 0.5254, 0.6009 / 1.4280, and at the spectral basis's narrower
# blocks, k = 18 and 54, 0.1756 / 0.7562 and 0.5019 / 1.6027; at k = 10
# every one of them: 16c's block 0.0101 / 0.0870, the 1M block 0.1055 /
# 0.5915, the multigrid's level blocks (windows 128 to 384) 0.0037-0.0039
# / 0.0094-0.0169 (its graph operator's, k = 19, 0.0056-0.0067 /
# 0.0128-0.0392), the unsharded Hilbert and cluster cores 0.0346 / 0.1011
# and 0.0358 / 0.1291; and at k = 6 16c's block 0.0081 / 0.0704, the 1M
# block 0.0717 / 0.4960, the Hilbert and cluster cores 0.0228 / 0.0992
# and 0.0247 / 0.1272 (polish_products.py --shards). bf16, against the
# tensor-core walk: the Hilbert core at k = 20 and 28, 0.0513 / 0.0833
# and 0.0691 / 0.0982 (polish_products.py --tables).
FULL_ROWS_K = {torch.float32: (6, 84), torch.bfloat16: (20, 28)}

# Widths at which a full-window band with its table takes the row-wise
# route with the Gram (K5: the partials in the product's blocks, then the
# walk's reduce), by the band's type: the span of the widths timed, at
# each of which it beats the route it replaces (on the card, NVIDIA H100
# 80GB HBM3, 700.00 W, polish_products.py --gram). fp32, against the
# staged route (the walk at 84): the 300k cluster core (window 1024) at
# k = 10, 20, 28, 39, 60, 84 0.0494 / 0.1972, 0.0670 / 0.2048, 0.0980 /
# 0.2119, 0.1526 / 0.2933, 0.2222 / 0.3409, 0.3978 / 0.7545 ms; the fp32
# Hilbert core (window 512) at k = 20, 28, 60, 84 0.0665 / 0.1747, 0.0974
# / 0.1809, 0.2209 / 0.2995, 0.3939 / 0.6634; the 1M cluster core at k =
# 60 0.6837 / 1.1002 (chip_smoke.py). bf16, against the tensor-core
# walk: the Hilbert core at k = 12, 20, 28 0.0542 / 0.1019, 0.0790 /
# 0.1212, 0.1072 / 0.1443 (k = 20: the fused-Gram training's 300
# launches).
FULL_GRAM_ROWS_K = {torch.float32: (10, 84), torch.bfloat16: (12, 28)}

# Narrowest window (band columns) on which an fp32 full-window band takes
# the row-wise route where the staged route would run one block of 64
# columns (32 < k <= 64): there the route wins on the cluster cores
# (window 1024) at k = 60, as above, and loses on the Hilbert core
# (window 512), 0.1415 / 0.1309 ms (polish_products.py --tables).
FULL_ROWS_MIN_WINDOW_64 = 1024

# Widest product the row-wise kernel takes (csrc/nonzero_spmm.cuh,
# kRowsMaxK), and the widest whose Gram it takes (kRowsGramMaxK: a tile's
# U and W rows in shared memory).
ROWS_KERNEL_MAX_K = 256
ROWS_GRAM_MAX_K = 128


def band_grid(n_tiles: int, k: int, dtype: torch.dtype, sms: int,
              with_gram: bool = False, col_block: int | None = None,
              warps: int | None = None, route: str | None = None,
              rows: bool = False,
              window: int | None = None) -> tuple[str, int, int]:
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
    block each. Before all of these, a band that carries a nonzero table
    (`rows`) takes the row-wise route over it, ceil(k / 4) lanes a row
    (8 columns a lane on a bf16 table), where k lies in the widths of
    its kind: a rolling band in BAND_ROWS_K (fp32: the polish's K X and
    K S on the 300k rolling band, k = 28 and 84) or BAND_BF16_ROWS_K
    (bf16: the 300k training's products), with the Gram in
    BAND_GRAM_ROWS_K of its type (per-tile partials of the walk's order,
    then the same reduce); a full-window band (a `BandedELL`, whose
    `window`, its band's columns, is given) without the Gram, in
    FULL_ROWS_K of its type, in fp32 where the staged route would run
    one block of 64 columns only on a window of FULL_ROWS_MIN_WINDOW_64
    columns or more, and with the Gram (K5) in FULL_GRAM_ROWS_K of its
    type; unless a `col_block` or `warps` is given (they name a grid of
    the block routes). On an fp32 band every choice sums each
    output, and each Gram partial, in the same order, so W and G have
    the same bits; on a bf16 band the row-wise route sums the exact
    products in another order than the walk's tensor cores.
    `warps` and `route` force a choice (the card tests and
    chip_smoke.py use them); one the kernels cannot take raises."""
    blocks_given = col_block is not None or warps is not None
    if col_block is None:
        col_block = default_col_block(k, dtype)
    if col_block not in (32, 64):
        raise ValueError(f"col_block must be 32 or 64, got {col_block}")
    can_stage = dtype == torch.float32 and k <= col_block
    small = n_tiles < 2 * sms
    if window is not None and with_gram:
        lo, hi = FULL_GRAM_ROWS_K.get(dtype, (1, 0))
    elif window is not None:
        lo, hi = FULL_ROWS_K.get(dtype, (1, 0))
        if can_stage and col_block == 64 and window < FULL_ROWS_MIN_WINDOW_64:
            lo, hi = 1, 0
    elif with_gram:
        lo, hi = BAND_GRAM_ROWS_K.get(dtype, (1, 0))
    else:
        lo, hi = {torch.float32: BAND_ROWS_K,
                  torch.bfloat16: BAND_BF16_ROWS_K}.get(dtype, (1, 0))
    if route is None:
        if rows and not blocks_given and lo <= k <= hi:
            route = "rows"
        else:
            route = ("staged" if can_stage and not (
                with_gram and small and col_block == 32) else "walk")
    if route not in BAND_ROUTES:
        raise ValueError(f"route must be one of {BAND_ROUTES}, got {route!r}")
    if route == "rows":
        if not (rows and (k <= ROWS_GRAM_MAX_K or not with_gram)
                and k <= ROWS_KERNEL_MAX_K and warps is None):
            raise ValueError(
                "the row-wise route takes a band with its nonzero table, "
                f"k <= {ROWS_KERNEL_MAX_K}, no warps, and the Gram at k <= "
                f"{ROWS_GRAM_MAX_K} (got {dtype}, table {rows}, "
                f"with_gram={with_gram}, k = {k}, window {window}, warps "
                f"{warps})")
        return route, col_block, 8
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
