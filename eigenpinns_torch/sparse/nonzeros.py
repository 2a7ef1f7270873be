"""The nonzeros of a tiled operator as a sliced ELL, for the kernels that
read them instead of the dense layout (`csrc/nonzero_spmm.cuh`).

Both tiled formats store a dense, mostly zero layout with an occupancy
table (`sparse/occupancy.py`): the strip-BSR strips (`BSRTile.data`) and
the bands (`RollingBanded.band`, `BandedELL.band`). Their walk reads
each occupied 16 x 16 sub-block whole, 1 KB of fp32 for ~11 nonzeros on
a cloud Laplacian. The table lists the nonzeros alone: 8 bytes each (an
fp32 value and an int32 U row) plus the padding to each 32-row slice's
widest row, and each row in the order in which the walk sums it (the
pieces of the table in order, then the sub-block's column group, then
the column), so that a kernel that chains each output's FFMA over its
row's entries gives the walk's bits.

A bf16 layout's table holds bf16 values (2 bytes each): the kernel
multiplies them by U rounded to bf16 and sums in fp32, what 'bf16' means
for the walk, though not in the walk's order (its tensor-core products
sum 16 terms an instruction). `NarrowTable.with_values` derives it from
the fp32 table, as `with_precision` rounds the layout; a bf16 build
lists its own layout's nonzeros.

`piece_table` builds it on the layout's device for either format from
the dense tensor, its occupancy table and where each 128 x 128 piece
sits in the matrix; `band_table` gives a band's pieces (full window or
rolling) and `bsr.narrow_table` the strips'. `table_spmm_plain` is the
plain torch reader of a table, and `launch_rows` the row-wise kernel's
launch, which both formats' wrappers share; `launch_rows_gram` adds a
square band's Gram U^T W (K1's on a rolling band, K5's on a full-window
one), in the order `gram_partials_plain` spells out.
"""

from __future__ import annotations

import dataclasses

import torch

from eigenpinns_torch.sparse.occupancy import (
    ROWS_GRAM_MAX_K,
    ROWS_KERNEL_MAX_K,
    sm_count,
)

SLICE = 32        # rows of a slice of the table: one a lane

# Occupied sub-blocks gathered at a time while a table is built (64 MB of
# fp32 values).
_GATHER = 1 << 16


@dataclasses.dataclass(frozen=True)
class NarrowTable:
    """The nonzeros of a tiled operator as a sliced ELL.

    Slice i holds rows [32 i, 32 i + 32); its entries are
    [slice_start[i], slice_start[i + 1]), 32 times the slice's widest
    row, and entry e of row 32 i + l sits at slice_start[i] + 32 e + l,
    so the 32 lanes of a warp read neighbouring addresses. Each row lists
    its nonzeros in the order in which the column-block walk sums them:
    the pieces of the layout in table order (strip-BSR: chunk, then slot;
    a band: its window's 128-column pieces), then the sub-block's column
    group, then the column inside it. Padding has value 0 and index -1.

    val: (L,) float32 or bfloat16, the layout's values bit for bit (a
         bf16 table may list a value that rounded to 0 from the fp32
         table it came from: `with_values`)
    idx: (L,) int32, the U row each value multiplies (-1: padding)
    slice_start: (n_slices + 1,) int64
    """

    val: torch.Tensor
    idx: torch.Tensor
    slice_start: torch.Tensor

    @property
    def n_slices(self) -> int:
        return self.slice_start.numel() - 1

    @property
    def nnz(self) -> int:
        return int((self.idx >= 0).sum())

    def with_values(self, dtype: torch.dtype) -> "NarrowTable":
        """The same table with its values in `dtype` (to bf16: rounded to
        nearest even, as the layout's own conversion rounds), sharing
        `idx` and `slice_start`; every entry stays, a value rounded to 0
        too, so the table still lists the nonzeros of the layout it came
        from."""
        if self.val.dtype == dtype:
            return self
        return dataclasses.replace(self, val=self.val.to(dtype))


def piece_table(dense: torch.Tensor, occupancy: torch.Tensor,
                row_tile: torch.Tensor, u_base: torch.Tensor,
                n_rows: int) -> NarrowTable:
    """The `NarrowTable` of an fp32 or bf16 layout of 128 x 128 pieces,
    built on its device, with values of the layout's type. `dense` is
    (R * 128, Q * 128) and `occupancy` its (R, Q) table; piece q = Q r + p
    (rows [128 r, 128 r + 128), columns [128 p, 128 p + 128) of `dense`)
    holds rows [128 row_tile[q], + 128) of the matrix, its column c
    multiplies U row u_base[q] + c. Rows are listed in piece order, then
    column (the walk's order); the table covers `n_rows` rows (a multiple
    of 32). The occupied sub-blocks are gathered, their nonzeros listed
    and sorted into that order."""
    if dense.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the nonzero table lists fp32 or bf16 values, got "
                         f"{dense.dtype}")
    R, Q = occupancy.shape
    T, sub = 128, 16
    device = dense.device
    if n_rows % SLICE:
        raise ValueError(f"the table covers whole slices of {SLICE} rows, "
                         f"got {n_rows}")
    n_slices = n_rows // SLICE
    span = R * Q * T                                  # keys within a row
    if n_rows * span >= 2**63:
        raise ValueError("the layout is too large for the table's sort key")
    row_tile = row_tile.to(device=device, dtype=torch.int64)
    u_base = u_base.to(device=device, dtype=torch.int64)
    shifts = torch.arange(64, device=device)
    q, b = torch.nonzero((occupancy.reshape(-1, 1) >> shifts) & 1,
                         as_tuple=True)
    blocks = dense.view(R, T // sub, sub, Q * T // sub, sub)
    rows, cols, vals, keys = [], [], [], []
    for lo in range(0, q.numel(), _GATHER):
        sl = slice(lo, lo + _GATHER)
        q_, i_, c_ = q[sl], b[sl] // 8, b[sl] % 8
        tiles = blocks[q_ // Q, i_, :, (q_ % Q) * 8 + c_, :]  # (m, 16, 16)
        m, rr, cc = torch.nonzero(tiles, as_tuple=True)
        q_, i_, c_ = q_[m], i_[m], c_[m]
        row = row_tile[q_] * T + i_ * sub + rr
        col = c_ * sub + cc                           # column in the piece
        rows.append(row)
        cols.append(u_base[q_] + col)
        vals.append(tiles[m, rr, cc])
        keys.append(row * span + q_ * T + col)
    cat = (lambda xs, dt: torch.cat(xs) if xs
           else torch.zeros(0, dtype=dt, device=device))
    order = torch.argsort(cat(keys, torch.int64))
    row = cat(rows, torch.int64)[order]
    if row.numel() and int(row.max()) >= n_rows:
        raise ValueError(f"a nonzero lies past the table's {n_rows} rows")
    counts = torch.bincount(row, minlength=n_rows)
    width = counts.view(n_slices, SLICE).amax(dim=1)
    slice_start = torch.zeros(n_slices + 1, dtype=torch.int64, device=device)
    slice_start[1:] = torch.cumsum(width * SLICE, 0)
    first = torch.cumsum(counts, 0) - counts       # each row's first entry
    rank = torch.arange(row.numel(), device=device) - first[row]
    dest = slice_start[row // SLICE] + rank * SLICE + row % SLICE
    L = int(slice_start[-1])
    val = torch.zeros(L, dtype=dense.dtype, device=device)
    idx = torch.full((L,), -1, dtype=torch.int32, device=device)
    val[dest] = cat(vals, dense.dtype)[order]
    idx[dest] = cat(cols, torch.int64)[order].int()
    return NarrowTable(val, idx, slice_start)


def band_table(band: torch.Tensor, occupancy: torch.Tensor,
               starts: torch.Tensor | None = None,
               pre: int = 0) -> NarrowTable:
    """The `NarrowTable` of a band of 128-row tiles, (n_pad, B) with
    its (n_pad / 128, B / 128) occupancy table: a full-window band
    (`starts`: piece p of tile t multiplies U rows starts[t] + 128 p
    onward) or a rolling band (`starts` None: U rows 128 t - pre +
    ((128 p - 128 t) mod B) onward, the window wrapping at its end). Each
    row lists its nonzeros in band-column order, which is the band
    kernels' order of summation (pieces, sub-block column, column)."""
    n_tiles, P = occupancy.shape
    B = band.shape[1]
    device = band.device
    t = torch.arange(n_tiles, dtype=torch.int64, device=device)[:, None]
    p = torch.arange(P, dtype=torch.int64, device=device)[None, :]
    if starts is None:
        base = 128 * t - pre + torch.remainder(128 * p - 128 * t, B)
    else:
        base = starts.to(device=device, dtype=torch.int64)[:, None] + 128 * p
    return piece_table(band, occupancy, t.expand(n_tiles, P).reshape(-1),
                       base.reshape(-1), band.shape[0])


def table_spmm_plain(t: NarrowTable, U: torch.Tensor, n: int) -> torch.Tensor:
    """W (n, k) = A U in fp32 read from a table, summed by `index_add_` in
    no fixed order; U rows at or past U's end read as zero. A bf16 table
    multiplies U rounded to bf16, as the kernel does."""
    k = U.shape[1]
    Uf = U.float()
    if t.val.dtype == torch.bfloat16:
        Uf = Uf.bfloat16().float()
    width = (t.slice_start[1:] - t.slice_start[:-1]) // SLICE
    slice_of = torch.repeat_interleave(
        torch.arange(t.n_slices, device=U.device), width * SLICE)
    e = torch.arange(t.val.numel(), device=U.device)
    row = slice_of * SLICE + (e - t.slice_start[slice_of]) % SLICE
    live = (t.idx >= 0) & (t.idx < U.shape[0])
    out = torch.zeros((t.n_slices * SLICE, k), dtype=torch.float32,
                      device=U.device)
    out.index_add_(0, row[live],
                   t.val[live, None].float() * Uf[t.idx[live].long()])
    return out[:n].to(U.dtype)


def check_table(t: NarrowTable, n: int, device: torch.device,
                dtype: torch.dtype = torch.float32) -> None:
    """Raises ValueError when the kernels cannot read `t` for n rows on
    `device` as a table of `dtype` values (the layout's type)."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the nonzero table holds fp32 or bf16 values, got "
                         f"{dtype}")
    if not (t.val.dtype == dtype and t.idx.dtype == torch.int32
            and t.slice_start.dtype == torch.int64
            and t.val.shape == t.idx.shape
            and t.n_slices * SLICE >= n
            and all(x.device == device and x.is_contiguous()
                    for x in (t.val, t.idx, t.slice_start))):
        raise ValueError(f"the nonzero table must hold contiguous {dtype} "
                         "values, int32 U rows and int64 slice starts for "
                         "every row, on the layout's device")


def table_hbm_bytes(t: NarrowTable, k: int, n: int, n_u: int) -> int:
    """Bytes the row-wise route moves for one (n, k) product over table
    `t` with a U of n_u rows: every entry, padding included (its value,
    4 or 2 bytes, and a 4-byte U row), the slice starts, each nonzero's
    U row (k fp32; for a bf16 table, its padded row of `copy_ld(k)` bf16
    in U's bf16 copy, after the rounding pass has read U and written the
    copy) and W written once."""
    u_row, out = 4 * k, 0
    if t.val.dtype == torch.bfloat16:
        ld = copy_ld(k)
        u_row, out = 2 * ld, n_u * (4 * k + 2 * ld)
    return int(out + t.val.numel() * (t.val.element_size() + 4)
               + t.slice_start.numel() * 8 + t.nnz * u_row + n * k * 4)


def copy_ld(k: int) -> int:
    """Row stride of U's bf16 copy for a product of width k: k rounded up
    to 8 values, so that each row starts on 16 bytes and a lane reads 8
    columns in one load (csrc/nonzero_spmm.cuh, `copy_ld`)."""
    return -(-k // 8) * 8


def launch_rows(fn, t: NarrowTable, U: torch.Tensor, n: int,
                stream: int) -> torch.Tensor:
    """(W, err): W (n, k) = A U launched by the row-wise kernel (`fn`, a
    library's C entry of signature (val, val_is_bf16, idx, slice_start,
    U, U_bf16, W, n, n_u, k, sms, stream)) over the table, and the CUDA
    error code of the launch, which the caller turns into its library's
    message. A bf16 table multiplies U rounded to bf16: this allocates
    the (n_u, copy_ld(k)) bf16 copy of U that the kernel's rounding pass
    writes and its product reads. The caller checks the table and U."""
    k = U.shape[1]
    if not 1 <= k <= ROWS_KERNEL_MAX_K:
        raise ValueError(f"the row-wise kernel takes 1 <= k <= "
                         f"{ROWS_KERNEL_MAX_K}, got {k}")
    bf16 = t.val.dtype == torch.bfloat16
    copy = (torch.empty((U.shape[0], copy_ld(k)), dtype=torch.bfloat16,
                        device=U.device) if bf16 else None)
    W = torch.empty((n, k), dtype=torch.float32, device=U.device)
    err = fn(t.val.data_ptr(), int(bf16), t.idx.data_ptr(),
             t.slice_start.data_ptr(), U.data_ptr(),
             None if copy is None else copy.data_ptr(), W.data_ptr(), n,
             U.shape[0], k, sm_count(U.device), stream)
    return W, err


GRAM_TILE = 128   # rows of one partial of the Gram (the walk's tile)


def gram_partials_plain(U: torch.Tensor, W: torch.Tensor, n_tiles: int):
    """(partial, G): the Gram U^T W in the order in which the band
    kernels sum it (`occ::tile_gram` on the walk, `nz::gram_tile` on
    the row-wise route, then `gram_reduce_kernel`). partial[t][i][j] sums
    U[r, i] W[r, j] over tile t's 128 rows in order from 0 (rows past U
    zero); lane y of the reduce sums the partials of tiles y, y + 128,
    ... in order, and G adds the 128 lane sums in order. In fp32, each
    step rounded (the kernels fuse each multiply-add, so their bits may
    differ by a rounding a step)."""
    n, k = U.shape
    if n_tiles * GRAM_TILE < n:
        raise ValueError(f"{n_tiles} tiles do not cover {n} rows")
    pad = n_tiles * GRAM_TILE - n
    Ut = torch.nn.functional.pad(U.float(), (0, 0, 0, pad)).view(
        n_tiles, GRAM_TILE, k)
    Wt = torch.nn.functional.pad(W.float(), (0, 0, 0, pad)).view(
        n_tiles, GRAM_TILE, k)
    partial = torch.zeros((n_tiles, k, k), dtype=torch.float32,
                          device=U.device)
    for r in range(GRAM_TILE):
        partial += Ut[:, r, :, None] * Wt[:, r, None, :]
    lanes = -(-n_tiles // GRAM_TILE) * GRAM_TILE
    by_lane = torch.nn.functional.pad(
        partial, (0, 0, 0, 0, 0, lanes - n_tiles)).view(-1, GRAM_TILE, k, k)
    sums = torch.zeros((GRAM_TILE, k, k), dtype=torch.float32,
                       device=U.device)
    for m in range(by_lane.shape[0]):
        sums += by_lane[m]
    G = torch.zeros((k, k), dtype=torch.float32, device=U.device)
    for y in range(GRAM_TILE):
        G += sums[y]
    return partial, G


def launch_rows_gram(fn, t: NarrowTable, U: torch.Tensor, n_tiles: int,
                     stream: int):
    """(W, G, err): `launch_rows` on a square operator (U has its n
    rows) with the Gram G = U^T W from per-tile partials of 128 rows and
    their ordered reduce (`fn`, a library's C entry of signature (val,
    val_is_bf16, idx, slice_start, U, U_bf16, W, partial, G, n, k,
    n_tiles, sms, stream)); `n_tiles` tiles cover the n rows.
    The Gram takes the unrounded U, also where a bf16 table multiplies
    its bf16 copy."""
    n, k = U.shape
    if not 1 <= k <= ROWS_GRAM_MAX_K:
        raise ValueError(f"the row-wise route's Gram takes 1 <= k <= "
                         f"{ROWS_GRAM_MAX_K}, got {k}")
    if n_tiles * GRAM_TILE < n:
        raise ValueError(f"{n_tiles} tiles do not cover {n} rows")
    bf16 = t.val.dtype == torch.bfloat16
    copy = (torch.empty((n, copy_ld(k)), dtype=torch.bfloat16,
                        device=U.device) if bf16 else None)
    W = torch.empty((n, k), dtype=torch.float32, device=U.device)
    partial = torch.empty((n_tiles, k, k), dtype=torch.float32,
                          device=U.device)
    G = torch.empty((k, k), dtype=torch.float32, device=U.device)
    err = fn(t.val.data_ptr(), int(bf16), t.idx.data_ptr(),
             t.slice_start.data_ptr(), U.data_ptr(),
             None if copy is None else copy.data_ptr(), W.data_ptr(),
             partial.data_ptr(), G.data_ptr(), n, k, n_tiles,
             sm_count(U.device), stream)
    return W, G, err
