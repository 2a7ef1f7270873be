"""Rolling-window banded format and its SpMM, on a hand-written CUDA kernel.

Port of `eigenpinns_tpu/sparse/rolling.py`. The host layout is the JAX
package's, byte for byte: the matrix is RCM-banded, every 128-row tile
sees a UNIFORM window of U (padded rows [t*tile, t*tile + B') with U
top-padded by `pre` zero rows), and the band's columns are rotated once
at build time so that row i's entry for column c sits at
band[i, (c + pre) mod B'], B' = B + tile.

The product W = A U runs on the rolling instantiation of the band kernel
in `csrc/banded_spmm.cu` for CUDA tensors (the port of the Pallas kernel
`_rolling_kernel_call`: B', `pre` and every tile's origin are multiples
of 128, so the rotation moves whole 128-column pieces and a rolling band
is a full-window band whose window starts are implicit and whose pieces
wrap) and on `rolling_spmm_plain`, a plain torch version of the same
function, for CPU tensors. The kernel walks the band's occupancy table
(`occupancy`, one 64-bit word per 128 x 128 piece of the rotated band:
`sparse/occupancy.py`) and reads and multiplies only the 16 x 16
sub-blocks that hold a nonzero: on the RCM-ordered Laplacian of a
300k-point cloud that is 4% of a band of 1.15e9 elements. Where
`band_grid` says so, it reads the band's nonzero table (`narrow`) instead,
one row at a time: the fp32 or bf16 row-wise route, with the Gram too
(per-tile partials in the walk's order). A CUDA tensor always reaches
the kernel or raises.

Autograd matches the JAX custom VJPs: the operator is a constant; the
backward pass of A U applies A^T through the same kernel (the stored
`transpose_rolling`, or A itself when A is symmetric); the fused Gram's
backward pass is dU = A^T (gW + U gG) + W gG^T.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from eigenpinns_torch.sparse.banded import band_occupancy, launch_band_kernel
from eigenpinns_torch.sparse.nonzeros import NarrowTable, band_table
from eigenpinns_torch.sparse.occupancy import default_col_block

PRECISIONS = ("highest", "high", "bf16")

# Launches of the CUDA kernel (one per wrapper call that reaches it), how
# many of them asked for the fused Gram, how many took the row-wise route
# over the band's nonzero table, and of those how many over a bf16 table
# and how many with the Gram.
rolling_kernel_launches = 0
rolling_gram_launches = 0
rolling_rows_launches = 0
rolling_rows_bf16_launches = 0
rolling_rows_gram_launches = 0


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class RollingBanded:
    """Column-rotated uniform-window banded matrix.

    band: (N_pad, B') — row i's entry for column c sits at
          band[i, (c + pre) mod B']; float32, or bfloat16 in 'bf16' mode
    pre:  top padding of U (multiple of tile): window(t) starts at
          original row t*tile - pre
    win:  B — the window height (B' = band.shape[1] = B + tile)
    n:    true row count; tile: rows per tile
    transpose_rolling: A^T in the same format (None = symmetric)
    mxu_precision: 'highest' | 'high' (both exact fp32 here) | 'bf16'
          (band stored bf16, U rounded to bf16, fp32 accumulation)
    occupancy: (N_pad / 128, B' / 128) int64 — bit 8 i + j of a word is
          set when the 16 x 16 sub-block (i, j) of that 128 x 128 piece
          of the rotated band holds a nonzero (`occupancy_mask(band)`,
          taken from the band as stored); the CUDA kernel needs it. None
          for a tile other than 128, which the kernel does not take.
    narrow: the band's nonzeros as a sliced ELL in the band's type
          (`nonzeros.band_table`: each row in the kernel's order of
          summation), which the row-wise route reads; built for a band
          with an occupancy table, None otherwise
    """

    band: torch.Tensor
    pre: int
    win: int
    n: int
    tile: int
    transpose_rolling: "RollingBanded | None" = None
    mxu_precision: str = "highest"
    occupancy: torch.Tensor | None = None
    narrow: NarrowTable | None = None

    def with_precision(self, precision: str) -> "RollingBanded":
        """Same operator, another precision mode. 'bf16' stores a bf16
        copy of the band; the other modes keep (or restore) fp32. The
        occupancy table is kept: rounding to bf16 can only turn a nonzero
        into a zero, so the source's table covers the copy's nonzeros.
        The nonzero table goes with the band: kept with the same band,
        its values rounded with the band's to bf16 (`with_values`,
        sharing its U rows and slices, as `BSRTile.with_precision` does),
        rebuilt from a band converted back to fp32."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        t = (None if self.transpose_rolling is None
             else self.transpose_rolling.with_precision(precision))
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        band = self.band.to(dtype)
        narrow = self.narrow
        if band is not self.band:
            narrow = (self.narrow.with_values(dtype)
                      if dtype == torch.bfloat16 and self.narrow is not None
                      else _narrow_of(band, self.occupancy, self.pre))
        return dataclasses.replace(self, band=band, mxu_precision=precision,
                                   transpose_rolling=t, narrow=narrow)

    @property
    def shape(self):
        return (self.n, self.n)

    def diagonal(self) -> torch.Tensor:
        """Row i's diagonal sits at band[i, (i + pre) mod B']."""
        bp = self.band.shape[1]
        rows = torch.arange(self.band.shape[0], device=self.band.device)
        return self.band[rows, (rows + self.pre) % bp][: self.n]

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, device="cuda",
                   tile: int = 128, reorder: bool = True,
                   max_bandwidth: int = 4096, with_transpose: bool = True):
        """Convert a scipy sparse matrix; returns (op, perm). Raises
        ValueError past max_bandwidth. The band is scattered on `device`
        from the nonzero triplets."""
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        A = A.tocsr()
        A.sum_duplicates()
        n = A.shape[0]
        if reorder:
            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        else:
            perm = np.arange(n)
        Ap = A[perm][:, perm].tocsr()

        n_pad = _round_up(max(n, tile), tile)
        coo = Ap.tocoo()
        t_of = coo.row // tile
        rel_lo = t_of * tile - coo.col        # how far cols reach LEFT
        rel_hi = coo.col - t_of * tile + 1    # ... and RIGHT
        pre = _round_up(max(int(rel_lo.max(initial=0)), 0), tile)
        post = max(int(rel_hi.max(initial=1)), tile)
        B = _round_up(pre + post, tile)
        # the Gram slices U's own rows out of the window
        B = max(B, pre + 2 * tile)
        if B > max_bandwidth:
            raise ValueError(
                f"uniform-window bandwidth {B} exceeds max_bandwidth="
                f"{max_bandwidth}; use the ELL/split path")
        bp = B + tile

        band = torch.zeros((n_pad, bp), dtype=torch.float32, device=device)
        rows = torch.as_tensor(coo.row.astype(np.int64), device=device)
        cols = torch.as_tensor(((coo.col + pre) % bp).astype(np.int64),
                               device=device)
        band[rows, cols] = torch.as_tensor(coo.data, dtype=torch.float32,
                                           device=device)
        band = band.to(dtype)

        transpose = None
        if with_transpose:
            d = (Ap - Ap.T).tocsr()
            if d.nnz and abs(d).max() > 1e-12 * max(abs(Ap).max(), 1e-300):
                transpose = cls.from_scipy(
                    Ap.T.tocsr(), dtype=dtype, device=device, tile=tile,
                    reorder=False, max_bandwidth=max_bandwidth,
                    with_transpose=False)[0]
        precision = "bf16" if dtype == torch.bfloat16 else "highest"
        occupancy = band_occupancy(band, tile)
        op = cls(band, pre, B, n, tile, transpose, precision, occupancy,
                 _narrow_of(band, occupancy, pre))
        return op, perm


def _narrow_of(band: torch.Tensor, occupancy: torch.Tensor | None,
               pre: int) -> NarrowTable | None:
    """The nonzero table of a band with an occupancy table, in the band's
    type, else None."""
    if occupancy is None:
        return None
    return band_table(band, occupancy, pre=pre)


# ---- plain torch version (CPU tensors, and the kernel's oracle) ---------

def rolling_spmm_plain(A: RollingBanded, U: torch.Tensor) -> torch.Tensor:
    """A @ U in fp32 by un-rotating each tile's window (the JAX package's
    `rolling_spmm_reference`). 'bf16' rounds U to bf16 first."""
    tile, bp = A.tile, A.band.shape[1]
    n_pad = A.band.shape[0]
    n_tiles = n_pad // tile
    Uf = U.float()
    if A.mxu_precision == "bf16":
        Uf = Uf.bfloat16().float()
    Up = F.pad(Uf, (0, 0, A.pre, n_pad + bp - A.pre - U.shape[0]))
    t = torch.arange(n_tiles, device=U.device)[:, None] * tile
    j = torch.arange(bp, device=U.device)[None, :]
    window = Up[t + torch.remainder(j - t, bp)]      # (n_tiles, B', k)
    W = torch.bmm(A.band.float().view(n_tiles, tile, bp), window)
    return W.reshape(n_pad, -1)[: A.n].to(U.dtype)


def rolling_spmm_gram_plain(A: RollingBanded, U: torch.Tensor):
    """(A @ U, U^T A U), the Gram from the unrounded U."""
    W = rolling_spmm_plain(A, U)
    return W, (U.float().T @ W.float()).to(U.dtype)


# ---- CUDA kernel wrapper -------------------------------------------------

def rolling_spmm_cuda(A: RollingBanded, U: torch.Tensor,
                      with_gram: bool = False, col_block: int | None = None,
                      warps: int | None = None, route: str | None = None):
    """Launch the rolling band kernel of csrc/banded_spmm.cu: W = A U, and
    G = U^T A U when `with_gram`. `col_block` (32 or 64 output columns
    per block), `warps` and `route` default to `band_grid`'s choice (the
    row-wise route over `A.narrow` where it applies, with the Gram too)
    and give the same bits whatever they are on an fp32 band; on a bf16
    band the row-wise route sums in another order than the walk's tensor
    cores. Raises on anything the kernel does not take:
    a tile other than 128 (the walk needs the rotation to move whole
    128-column pieces), no occupancy table, CPU tensors."""
    global rolling_kernel_launches, rolling_gram_launches
    global rolling_rows_launches, rolling_rows_bf16_launches
    global rolling_rows_gram_launches
    band = A.band
    if A.tile != 128 or A.pre % 128 or A.win + 128 != band.shape[1]:
        raise ValueError("the rolling band kernel takes tile = 128, pre a "
                         f"multiple of 128 and B' = win + 128 (tile {A.tile},"
                         f" pre {A.pre}, win {A.win}, band "
                         f"{tuple(band.shape)})")
    want = torch.bfloat16 if A.mxu_precision == "bf16" else torch.float32
    if band.dtype != want:
        raise ValueError(f"'{A.mxu_precision}' needs a {want} band, got "
                         f"{band.dtype}")
    W, G, route = launch_band_kernel(band, None, A.pre, A.occupancy, U, A.n,
                                     with_gram, col_block, warps, route,
                                     A.narrow)
    rows = route == "rows"
    rolling_kernel_launches += 1
    rolling_gram_launches += int(with_gram)
    rolling_rows_launches += int(rows)
    rolling_rows_bf16_launches += int(rows and band.dtype == torch.bfloat16)
    rolling_rows_gram_launches += int(rows and with_gram)
    return (W, G) if with_gram else W


def _impl(A: RollingBanded, U: torch.Tensor) -> torch.Tensor:
    if U.is_cuda:
        return rolling_spmm_cuda(A, U.contiguous())
    return rolling_spmm_plain(A, U)


def _impl_gram(A: RollingBanded, U: torch.Tensor):
    if U.is_cuda:
        return rolling_spmm_cuda(A, U.contiguous(), with_gram=True)
    return rolling_spmm_gram_plain(A, U)


def _transpose(A: RollingBanded) -> RollingBanded:
    return A.transpose_rolling if A.transpose_rolling is not None else A


class _RollingSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, U, A):
        ctx.A = A
        return _impl(A, U)

    @staticmethod
    def backward(ctx, g):
        return _impl(_transpose(ctx.A), g), None


class _RollingSpmmGram(torch.autograd.Function):
    @staticmethod
    def forward(ctx, U, A):
        W, G = _impl_gram(A, U)
        ctx.A = A
        ctx.save_for_backward(U, W)
        return W, G

    @staticmethod
    def backward(ctx, gW, gG):
        U, W = ctx.saved_tensors
        dU = _impl(_transpose(ctx.A), gW + U @ gG) + W @ gG.T
        return dU, None


def rolling_spmm(A: RollingBanded, U: torch.Tensor) -> torch.Tensor:
    """A @ U; backward applies A^T in the same kernel."""
    return _RollingSpmm.apply(U, A)


def rolling_spmm_gram(A: RollingBanded, U: torch.Tensor):
    """Fused (A @ U, U^T A U); dU = A^T (gW + U gG) + W gG^T."""
    return _RollingSpmmGram.apply(U, A)
