"""Full-window banded format and its SpMM, on hand-written CUDA kernels.

Port of `eigenpinns_tpu/sparse/banded.py`. The host layout is the JAX
package's, byte for byte: after a reverse Cuthill-McKee ordering every
128-row tile t multiplies a densified (128, B) slice of the band against
the contiguous window U[starts[t] : starts[t] + B]:

  * `band` (N_pad, B): row i's entry for column c sits at
    band[i, c - starts[i // tile]]; B is the widest tile's column spread,
    rounded up to 128;
  * `starts` (N_pad / tile,) int32, clamped to N_pad - B, so a window can
    reach past n (those U rows read as zero);
  * `transpose_banded`: A^T in the same layout for a nonsymmetric A (None
    means A is its own transpose).

Two kernels in `csrc/banded_spmm.cu` compute W = A U for CUDA tensors:
K4 (port of the Pallas kernel `banded_spmm_pallas`) and K5, which adds
the fused Gram G = U^T A U (port of `banded_spmm_gram_pallas`); the same
source holds the rolling band's kernel (`sparse/rolling.py`), which
launches through `launch_band_kernel` here. Both
walk the band's occupancy table (`occupancy`, one 64-bit word per
128 x 128 piece of a tile's window: `sparse/occupancy.py`) and read and
multiply only the 16 x 16 sub-blocks that hold a nonzero. CPU tensors
take `banded_spmm_plain` / `banded_spmm_gram_plain`, the plain
torch version of the same functions. A CUDA tensor always reaches a
kernel or raises.

A bf16 band is a `dtype=` of the build, as in the JAX package: both
kernels, and the plain version, round U to bf16 and accumulate in fp32,
as both Pallas kernels do (the JAX CPU reference does not round U,
ROADMAP F10). The fused Gram is taken from the fp32 W and the unrounded
U.

Autograd matches the JAX custom VJPs: the operator is a constant; the
backward pass of A U applies A^T through the same kernel; the fused
Gram's backward pass is dU = A^T (gW + U gG) + W gG^T.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from eigenpinns_torch.sparse.occupancy import (
    default_col_block,
    occupancy_mask,
    occupied_blocks,
)

# Launches of each CUDA kernel (one per wrapper call that reaches it).
banded_kernel_launches = {"spmm": 0, "spmm_gram": 0}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def scatter_band(rows: np.ndarray, local: np.ndarray, data: np.ndarray,
                 shape: tuple, dtype, device) -> torch.Tensor:
    """The (N_pad, B) band from its nonzero triplets, scattered on `device`
    in fp32 and converted there (numpy has no bf16; the dense band is
    never built on the host)."""
    device = torch.device(device)
    band = torch.zeros(shape, dtype=torch.float32, device=device)
    band[torch.as_tensor(rows.astype(np.int64), device=device),
         torch.as_tensor(local.astype(np.int64), device=device)] = \
        torch.as_tensor(data, dtype=torch.float32, device=device)
    return band.to(dtype)


def band_occupancy(band: torch.Tensor, tile: int) -> torch.Tensor | None:
    """The band's occupancy table (None for a tile the kernels do not
    take)."""
    return occupancy_mask(band) if tile == 128 else None


@dataclasses.dataclass(frozen=True)
class BandedELL:
    """Row-tiled banded-dense matrix.

    band:   (N_pad, B) float32 or bfloat16 — densified rows, columns
            relative to the tile's window start
    starts: (n_tiles,) int32 — window start row of U for each tile
    n:      true row count (N_pad = round_up(n, tile))
    n_cols: column count of the (square) operator
    tile:   rows per tile
    transpose_banded: A^T in the same layout (None = symmetric)
    occupancy: (N_pad / 128, B / 128) int64 — bit 8 i + j of a word is
            set when the 16 x 16 sub-block (i, j) of that 128 x 128 piece
            of the band holds a nonzero (`occupancy_mask(band)`, taken
            from the band as stored); the CUDA kernels need it
    """

    band: torch.Tensor
    starts: torch.Tensor
    n: int
    n_cols: int
    tile: int
    transpose_banded: "BandedELL | None" = None
    occupancy: torch.Tensor | None = None

    @property
    def bandwidth(self) -> int:
        return self.band.shape[1]

    @property
    def shape(self):
        return (self.n, self.n_cols)

    def diagonal(self) -> torch.Tensor:
        """Main diagonal: row i's entry sits at band[i, i - starts[tile]]."""
        n_pad = self.band.shape[0]
        rows = torch.arange(n_pad, device=self.band.device)
        local = rows - self.starts.long()[rows // self.tile]
        local = torch.clamp(local, 0, self.bandwidth - 1)
        return self.band[rows, local][: self.n]

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, device="cuda",
                   tile: int = 128, reorder: bool = True,
                   max_bandwidth: int = 4096, with_transpose: bool = True):
        """Convert a scipy sparse matrix; returns (op, perm), op = P A P^T.

        Raises ValueError when the post-RCM tile bandwidth exceeds
        `max_bandwidth` (use the ELL or strip-BSR path instead). The
        layout tables are built on the host; the band is scattered on
        `device` from the nonzero triplets."""
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
        n_tiles = n_pad // tile
        indptr, indices, data = Ap.indptr, Ap.indices, Ap.data

        # Per-tile window [min col, max col] over the tile's rows.
        tile_ptr = indptr[np.minimum(np.arange(0, n_pad + tile, tile), n)]
        nnz_tile = np.diff(tile_ptr)
        starts = np.zeros(n_tiles, dtype=np.int64)
        ends = np.zeros(n_tiles, dtype=np.int64)
        nonempty = nnz_tile > 0
        if indices.size:
            red_idx = np.minimum(tile_ptr[:-1], max(indices.size - 1, 0))
            mins = np.minimum.reduceat(indices, red_idx)
            maxs = np.maximum.reduceat(indices, red_idx)
            starts[nonempty] = mins[nonempty]
            ends[nonempty] = maxs[nonempty]
        spread = int((ends - starts + 1).max()) if n_tiles else 1
        if spread > max_bandwidth:
            raise ValueError(
                f"post-RCM tile bandwidth {spread} exceeds max_bandwidth="
                f"{max_bandwidth}; banded densification would cost "
                f"{spread}x row-degree FLOPs — use the ELL path")
        B = _round_up(max(spread, 128), 128)
        # Clamp starts so every window stays inside N_pad rows.
        starts = np.minimum(starts, max(n_pad - B, 0)).astype(np.int32)

        rows = np.repeat(np.arange(n), np.diff(indptr))
        local = indices - starts[rows // tile]
        band = scatter_band(rows, local, data, (n_pad, B), dtype, device)

        transpose = None
        if with_transpose:
            d = (Ap - Ap.T).tocsr()
            if d.nnz and abs(d).max() > 1e-12 * max(abs(Ap).max(), 1e-300):
                transpose = cls.from_scipy(
                    Ap.T.tocsr(), dtype=dtype, device=device, tile=tile,
                    reorder=False, max_bandwidth=max_bandwidth,
                    with_transpose=False)[0]

        op = cls(band, torch.as_tensor(starts, device=band.device), n, n,
                 tile, transpose, band_occupancy(band, tile))
        return op, perm


# ---- plain torch version (CPU tensors, and the kernels' oracle) ---------

def banded_spmm_plain(A: BandedELL, U: torch.Tensor) -> torch.Tensor:
    """A @ U in fp32: gather each tile's U window, one batched product.
    A bf16 band rounds U to bf16 first, as the kernels do."""
    tile, B = A.tile, A.bandwidth
    n_pad = A.band.shape[0]
    n_tiles = n_pad // tile
    Uf = U.float()
    if A.band.dtype == torch.bfloat16:
        Uf = Uf.bfloat16().float()
    Up = torch.nn.functional.pad(Uf, (0, 0, 0, n_pad + B - U.shape[0]))
    idx = (A.starts.long()[:, None]
           + torch.arange(B, device=U.device)[None, :])
    W = torch.bmm(A.band.float().view(n_tiles, tile, B), Up[idx])
    return W.reshape(n_pad, -1)[: A.n].to(U.dtype)


def banded_spmm_gram_plain(A: BandedELL, U: torch.Tensor):
    """(A @ U, U^T A U), the Gram from the fp32 W and the unrounded U."""
    W = banded_spmm_plain(A, U)
    return W, (U.float().T @ W.float()).to(U.dtype)


# ---- CUDA kernel wrapper -------------------------------------------------

@functools.cache
def build_kernel() -> ctypes.CDLL:
    """Compile csrc/banded_spmm.cu (once per source hash), load it and
    declare its C interface."""
    from eigenpinns_torch.utils.cuda_build import load_library

    lib = load_library("banded_spmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.epk_banded_spmm.restype = i
    lib.epk_banded_spmm.argtypes = [p, i, p, i, p, p, p, p, p, i, i, i, i,
                                    i, p]
    lib.epk_banded_error_string.restype = ctypes.c_char_p
    lib.epk_banded_error_string.argtypes = [i]
    return lib


def launch_band_kernel(band: torch.Tensor, starts: torch.Tensor | None,
                       pre: int, occ: torch.Tensor | None, U: torch.Tensor,
                       n: int, with_gram: bool, col_block: int | None):
    """One launch of csrc/banded_spmm.cu on a square n x n operator: a
    full-window band (`starts` given) or a rolling band (`starts` None,
    windows `pre` rows above their tile). Checks what both layouts share
    (the band, its occupancy table, U, `col_block`), allocates the
    outputs and raises when the launch fails. Returns (W, G); G is None
    without `with_gram`."""
    if occ is None:
        raise ValueError("the band kernels need the band's occupancy "
                         "table (from_scipy makes it; "
                         "occupancy_mask(band) for a hand-made operator)")
    if not (U.is_cuda and band.is_cuda and U.device == band.device):
        raise ValueError("the band kernels need U and the band on one "
                         f"CUDA device (got {U.device}, {band.device})")
    if band.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"the band must be float32 or bfloat16, got "
                         f"{band.dtype}")
    if (U.dtype != torch.float32 or U.dim() != 2 or U.shape[0] != n
            or U.shape[1] == 0):
        raise ValueError(f"U must be float32 ({n}, k >= 1), got "
                         f"{U.dtype} {tuple(U.shape)}")
    n_pad, B = band.shape
    if n_pad % 128 or B % 128 or not 0 < n <= n_pad:
        raise ValueError("the band kernels take 128-row tiles and B a "
                         f"multiple of 128 (band {tuple(band.shape)}, "
                         f"n = {n})")
    if (occ.dtype != torch.int64 or occ.shape != (n_pad // 128, B // 128)
            or occ.device != band.device or not occ.is_contiguous()):
        raise ValueError("the occupancy table must be contiguous int64 "
                         "(n_pad / 128, B / 128) on the band's device")
    if not (band.is_contiguous() and U.is_contiguous()
            and band.data_ptr() % 16 == 0):
        raise ValueError("the band must be contiguous and 16-byte aligned, "
                         "U contiguous")
    k = U.shape[1]
    if col_block is None:
        col_block = default_col_block(k, band.dtype)
    if col_block not in (32, 64):
        raise ValueError(f"col_block must be 32 or 64, got {col_block}")
    # One block per (tile, column block), on the grid's x axis.
    if (n_pad // 128) * -(-k // col_block) >= 2**31:
        raise ValueError(f"{n_pad // 128} tiles x k = {k} exceed the grid")
    W = torch.empty((n, k), dtype=torch.float32, device=U.device)
    partial = G = None
    if with_gram:
        partial = torch.empty((n_pad // 128, k, k), dtype=torch.float32,
                              device=U.device)
        G = torch.empty((k, k), dtype=torch.float32, device=U.device)
    lib = build_kernel()
    stream = torch.cuda.current_stream(U.device).cuda_stream
    err = lib.epk_banded_spmm(
        band.data_ptr(), int(band.dtype == torch.bfloat16),
        None if starts is None else starts.data_ptr(), pre, occ.data_ptr(),
        U.data_ptr(), W.data_ptr(),
        None if partial is None else partial.data_ptr(),
        None if G is None else G.data_ptr(), n, n_pad, B, k, col_block,
        stream)
    if err != 0:
        raise RuntimeError("banded_spmm kernel launch failed: "
                           + lib.epk_banded_error_string(err).decode())
    return W, G


def banded_spmm_cuda(A: BandedELL, U: torch.Tensor, with_gram: bool = False,
                     col_block: int | None = None):
    """Launch csrc/banded_spmm.cu: W = A U (K4), and with `with_gram` also
    G = U^T A U (K5). `col_block` (32 or 64 output columns per block)
    defaults to `default_col_block(k, band.dtype)`. Raises on anything
    the kernels do not take."""
    band, starts = A.band, A.starts
    n_pad = band.shape[0]
    if A.tile != 128 or A.n != A.n_cols:
        raise ValueError("the banded kernels take a square operator with "
                         f"128-row tiles (tile {A.tile}, shape {A.shape})")
    if (starts.dtype != torch.int32 or starts.shape != (n_pad // 128,)
            or starts.device != band.device or not starts.is_contiguous()):
        raise ValueError("starts must be contiguous int32 (n_pad / 128,) "
                         "on the band's device")
    W, G = launch_band_kernel(band, starts, 0, A.occupancy, U, A.n,
                              with_gram, col_block)
    banded_kernel_launches["spmm_gram" if with_gram else "spmm"] += 1
    return (W, G) if with_gram else W


def banded_spmm_hbm_bytes(A: BandedELL, k: int, with_gram: bool = False) -> int:
    """Bytes the kernels move for one (n, k) fp32 product. For every
    occupied 16 x 16 sub-block of the band: its 256 band values and the
    16 x k fp32 U rows it multiplies. Then the occupancy table and
    starts read once and W written once; with the Gram, the tile's own U
    rows read once more, the per-tile partials written and read, and G
    written. A sub-block and its U rows count once per product: the
    column blocks of a row tile are launched next to each other and
    share them through L2. This is the kernels' traffic, not the least
    the product needs: that counts only the band's nonzeros."""
    sub_b = 16 * 16 * A.band.element_size() + 16 * k * 4
    out = occupied_blocks(A.occupancy) * sub_b
    out += A.occupancy.numel() * 8 + A.starts.numel() * 4 + A.n * k * 4
    if with_gram:
        out += A.n * k * 4 + (2 * A.starts.numel() + 1) * k * k * 4
    return int(out)


def _impl(A: BandedELL, U: torch.Tensor) -> torch.Tensor:
    if U.is_cuda:
        return banded_spmm_cuda(A, U.contiguous())
    return banded_spmm_plain(A, U)


def _impl_gram(A: BandedELL, U: torch.Tensor):
    if U.is_cuda:
        return banded_spmm_cuda(A, U.contiguous(), with_gram=True)
    return banded_spmm_gram_plain(A, U)


def _transpose(A: BandedELL) -> BandedELL:
    return A.transpose_banded if A.transpose_banded is not None else A


class _BandedSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, U, A):
        ctx.A = A
        return _impl(A, U)

    @staticmethod
    def backward(ctx, g):
        return _impl(_transpose(ctx.A), g), None


class _BandedSpmmGram(torch.autograd.Function):
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


def banded_spmm(A: BandedELL, U: torch.Tensor) -> torch.Tensor:
    """A @ U; the backward pass applies A^T in the same kernel (K4)."""
    return _BandedSpmm.apply(U, A)


def banded_spmm_gram(A: BandedELL, U: torch.Tensor):
    """Fused (A @ U, U^T A U) in one pass over the band (K5);
    dU = A^T (gW + U gG) + W gG^T, with A^T applied by K4."""
    return _BandedSpmmGram.apply(U, A)
