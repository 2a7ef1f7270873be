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
    band_grid,
    default_col_block,
    occupancy_mask,
    occupied_blocks,
    sm_count,
)

# Launches of each CUDA kernel (one per wrapper call that reaches it):
# K4 on a square operator, K4 on a rectangular block (a shard of the
# sharded path), K5.
banded_kernel_launches = {"spmm": 0, "spmm_rect": 0, "spmm_gram": 0}


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
    n_cols: column count: n for a square operator; a rectangular block
            (a shard's rows against its halo window, or its transpose:
            `parallel/sharded_banded.py`) has its own
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
    A bf16 band rounds U to bf16 first, as the kernels do. U is padded
    with zero rows to N_pad + B when it is shorter; a longer U (a halo
    window of a rectangular block) is read as it is, as the JAX
    `pad_u` does."""
    tile, B = A.tile, A.bandwidth
    n_pad = A.band.shape[0]
    n_tiles = n_pad // tile
    Uf = U.float()
    if A.band.dtype == torch.bfloat16:
        Uf = Uf.bfloat16().float()
    Up = torch.nn.functional.pad(
        Uf, (0, 0, 0, max(n_pad + B - U.shape[0], 0)))
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
                                    i, i, i, i, p]
    lib.epk_banded_error_string.restype = ctypes.c_char_p
    lib.epk_banded_error_string.argtypes = [i]
    return lib


def launch_band_kernel(band: torch.Tensor, starts: torch.Tensor | None,
                       pre: int, occ: torch.Tensor | None, U: torch.Tensor,
                       n: int, with_gram: bool, col_block: int | None,
                       warps: int | None = None, route: str | None = None):
    """One launch of csrc/banded_spmm.cu, W (n, k) = A U: a full-window
    band (`starts` given; U of any length >= 1, rows past its end read
    as zero) or a rolling band (`starts` None, windows `pre` rows above
    their tile; U has n rows). The Gram takes U with n rows. The route
    and grid come from `band_grid` (`col_block`, `warps` and `route`
    force them). Checks what both layouts share (the band, its occupancy
    table, U, the grid), allocates the outputs and raises when the
    launch fails. Returns (W, G); G is None without `with_gram`."""
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
    square = starts is None or with_gram
    if (U.dtype != torch.float32 or U.dim() != 2 or U.shape[1] == 0
            or U.shape[0] == 0 or (square and U.shape[0] != n)):
        rows = n if square else "n_u >= 1"
        raise ValueError(f"U must be float32 ({rows}, k >= 1), got "
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
    route, col_block, warps = band_grid(
        n_pad // 128, k, band.dtype, sm_count(U.device), with_gram,
        col_block, warps, route)
    # One block per (tile, column block) or per (tile, warps stripes), on
    # the grid's x axis.
    if (n_pad // 128) * max(-(-k // col_block), 8 // warps) >= 2**31:
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
        None if G is None else G.data_ptr(), n, U.shape[0], n_pad, B, k,
        col_block, warps, int(route == "staged"), stream)
    if err != 0:
        raise RuntimeError("banded_spmm kernel launch failed: "
                           + lib.epk_banded_error_string(err).decode())
    return W, G


def banded_spmm_cuda(A: BandedELL, U: torch.Tensor, with_gram: bool = False,
                     col_block: int | None = None, warps: int | None = None,
                     route: str | None = None):
    """Launch csrc/banded_spmm.cu: W = A U (K4), and with `with_gram` also
    G = U^T A U (K5). K4 takes a rectangular block too, with U of any
    length >= 1 (rows past U's end read as zero); K5 takes a square
    operator only. `col_block` (32 or 64 output columns per block),
    `warps` and `route` default to `band_grid`'s choice and give the
    same bits whatever they are. Raises on anything the kernels do not
    take."""
    band, starts = A.band, A.starts
    n_pad = band.shape[0]
    if A.tile != 128:
        raise ValueError(f"the banded kernels take 128-row tiles (tile "
                         f"{A.tile})")
    if with_gram and A.n != A.n_cols:
        raise ValueError("the fused Gram (K5) takes a square operator, got "
                         f"shape {A.shape}")
    if (starts.dtype != torch.int32 or starts.shape != (n_pad // 128,)
            or starts.device != band.device or not starts.is_contiguous()):
        raise ValueError("starts must be contiguous int32 (n_pad / 128,) "
                         "on the band's device")
    W, G = launch_band_kernel(band, starts, 0, A.occupancy, U, A.n,
                              with_gram, col_block, warps, route)
    banded_kernel_launches["spmm_gram" if with_gram else
                           "spmm" if A.n == A.n_cols else "spmm_rect"] += 1
    return (W, G) if with_gram else W


def stage_unions(occupancy: torch.Tensor, warps: int) -> torch.Tensor:
    """The staged route's union bytes: (n_tiles * 8 / warps, P) uint8,
    row b the block b of the launch (tile b // (8 / warps), stripes
    warps * (b % (8 / warps)) onward), column p the OR of the block's
    stripe bytes of piece p of its tile. Bit j set: the block stages U
    group j of the piece (16 rows), for all its stripes at once."""
    T, P = occupancy.shape
    b = occupancy.contiguous().view(torch.uint8).view(T, P, 8 // warps,
                                                       warps)
    u = b[..., 0].clone()
    for i in range(1, warps):
        u |= b[..., i]
    return u.permute(0, 2, 1).reshape(T * (8 // warps), P)


def stage_group_rows(n_tiles: int, B: int, starts: torch.Tensor | None = None,
                     pre: int = 0) -> torch.Tensor:
    """(n_tiles, B / 128, 8) int64: the first U row of group j (16 rows)
    of piece p of tile t: starts[t] + 128 p + 16 j for a full-window
    band; for a rolling band (`starts` None) the rotated window's row,
    128 t - pre + ((128 p - 128 t) mod B) + 16 j."""
    P = B // 128
    t = torch.arange(n_tiles, dtype=torch.int64)[:, None, None]
    p = torch.arange(P, dtype=torch.int64)[None, :, None]
    j = torch.arange(8, dtype=torch.int64)[None, None, :]
    if starts is None:
        base = 128 * t - pre + torch.remainder(128 * p - 128 * t, B)
    else:
        base = starts.cpu().long()[:, None, None] + 128 * p
    return base + 16 * j


# Classes of a staged U group (`stage_group_classes`).
STAGE_BULK, STAGE_UNALIGNED, STAGE_EDGE = 0, 1, 2


def stage_group_classes(rows: torch.Tensor, n_u: int, k: int,
                        u_offset: int = 0) -> torch.Tensor:
    """How the staged route copies each group of `stage_group_rows`:
    STAGE_BULK, one cp.async.bulk of 64 k bytes (all 16 rows in [0,
    n_u) and a 16-byte aligned start); STAGE_UNALIGNED, the lanes'
    4-byte copies (whole, but row * k + u_offset is not a multiple of 4
    floats: odd k, or an arbitrary window start); STAGE_EDGE, the lanes'
    copies with the rows outside [0, n_u) zero-filled. `u_offset`: U's
    address in floats, mod 4 (0 for a fresh allocation)."""
    whole = (rows >= 0) & (rows + 16 <= n_u)
    aligned = torch.remainder(rows * k + u_offset, 4) == 0
    out = torch.full(rows.shape, STAGE_EDGE, dtype=torch.int8)
    out[whole & aligned] = STAGE_BULK
    out[whole & ~aligned] = STAGE_UNALIGNED
    return out


def band_u_bytes(occupancy: torch.Tensor, k: int, route: str,
                 warps: int = 8) -> int:
    """Bytes of U one launch of the band kernels reads, 16 rows of k
    fp32 a group: on the walk, a group for every occupied sub-block
    (each stripe fetches its own, and the column blocks split the
    columns); on the staged route, a group for every set bit of
    `stage_unions` (zero-filled rows outside U count as read)."""
    if route == "walk":
        groups = occupied_blocks(occupancy)
    else:
        groups = occupied_blocks(
            stage_unions(occupancy, warps).to(torch.int64))
    return int(groups) * 16 * k * 4


def banded_spmm_hbm_bytes(A: BandedELL, k: int, with_gram: bool = False,
                          route: str = "walk", warps: int = 8) -> int:
    """Bytes the kernels move for one (n, k) fp32 product. For every
    occupied 16 x 16 sub-block of the band: its 256 band values; the U
    groups `band_u_bytes` counts for the route. Then the occupancy
    table and starts read once and W written once; with the Gram, the
    tile's own U rows read once more, the per-tile partials written and
    read, and G written. A sub-block counts once per product: the
    column blocks of a row tile are launched next to each other and
    share it through L2. This is the kernels' traffic, not the least
    the product needs: that counts only the band's nonzeros."""
    out = occupied_blocks(A.occupancy) * 16 * 16 * A.band.element_size()
    out += band_u_bytes(A.occupancy, k, route, warps)
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
