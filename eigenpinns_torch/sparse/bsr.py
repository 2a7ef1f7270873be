"""Chunk-compact strip-BSR format and its SpMM, on hand-written CUDA kernels.

Port of `eigenpinns_tpu/sparse/bsr.py`. The host layout is the JAX
package's, byte for byte: only the nonempty 128x128 tiles of the (RCM
ordered) matrix are stored, ragged per 128-row tile and padded up to a
multiple of `chunk` (C) tiles:

  * `data` (S*T, C*T): chunk s holds C horizontally stacked T x T tiles of
    ONE row tile; a row tile with nw nonempty tiles owns
    ceil(max(nw, 1) / C) consecutive chunks (pad slots are zero tiles);
  * `cid` (S, C): chunk slot -> column tile id (pad slots repeat a valid
    id of the same row tile);
  * `rowid` (S,), nondecreasing: the row tile of each chunk;
  * the group tables `gcid` / `lcid` / `gid`: for each group of G row
    tiles the union of their column tiles, and each slot's place in it
    (G is halved until every union holds at most 64 tiles).

Two kernels in `csrc/bsr_spmm.cu` compute W = A U for CUDA tensors: the
grouped one (port of the Pallas kernel `bsr_spmm_pallas_grouped`, which
reads column tiles through the group tables) when the operator has group
tables, the burst one (port of `bsr_spmm_pallas`, which reads them
through `cid`) otherwise. Both walk the operator's occupancy table
(`occupancy`, one 64-bit word per slot: `sparse/occupancy.py`) and read
and multiply only the 16 x 16 sub-blocks of each tile that hold a
nonzero; a pad slot's word is 0. On fp32 strips at k <= NARROW_MAX_K
both take the narrow path instead: one lane a row, over the operator's
nonzeros as a sliced ELL (`NarrowTable`, built from the strips), summed
in the walk's order, so W has the walk's bits. CPU tensors take
`bsr_spmm_plain`, the plain torch version of the same function. A CUDA
tensor always reaches a kernel or raises.

Autograd matches the JAX custom VJP: the operator is a constant and the
backward pass applies A^T through the same dispatcher (the stored
`transpose_bsr`, or A itself when A is symmetric).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import scipy.sparse as sp
import torch

from eigenpinns_torch.sparse.occupancy import (
    default_col_block,
    occupancy_mask,
    occupied_blocks,
)
from eigenpinns_torch.sparse.occupancy import sm_count as _sm_count

PRECISIONS = ("highest", "high", "bf16")

# Launches of each CUDA kernel (one per wrapper call that reaches it);
# "narrow" counts those of them that took the narrow path.
bsr_kernel_launches = {"grouped": 0, "burst": 0, "narrow": 0}

# Widest product the narrow path takes (fp32 strips, col_block=None).
NARROW_MAX_K = 8
SLICE = 32        # rows of a slice of the narrow table: one a lane


@dataclasses.dataclass(frozen=True)
class NarrowTable:
    """The nonzeros of fp32 strips as a sliced ELL, for the narrow path.

    Slice i holds rows [32 i, 32 i + 32); its entries are
    [slice_start[i], slice_start[i + 1]), 32 times the slice's widest
    row, and entry e of row 32 i + l sits at slice_start[i] + 32 e + l,
    so the 32 lanes of a warp read neighbouring addresses. Each row lists
    its nonzeros in the order in which the column-block walk sums them:
    slot, then the sub-block's column group, then the column inside it.
    Padding has value 0 and index -1.

    val: (L,) float32, the strips' values bit for bit
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


# Occupied sub-blocks gathered at a time while a table is built (64 MB of
# fp32 values).
_GATHER = 1 << 16


def narrow_table(data: torch.Tensor, occupancy: torch.Tensor,
                 rowid: torch.Tensor, cid: torch.Tensor,
                 n_row_tiles: int) -> NarrowTable:
    """The `NarrowTable` of fp32 strips, built on their device from the
    strips and the occupancy table: the occupied 16 x 16 sub-blocks are
    gathered, their nonzeros listed and sorted into the walk's order
    within each row."""
    if data.dtype != torch.float32:
        raise ValueError(f"the narrow table lists fp32 strips, got "
                         f"{data.dtype}")
    S, C = cid.shape
    T, sub = 128, 16
    device = data.device
    n_slices = n_row_tiles * T // SLICE
    span = C * T                                   # strip columns
    if n_slices * SLICE * S * span >= 2**63:
        raise ValueError("the strips are too large for the table's sort key")
    shifts = torch.arange(64, device=device)
    q, b = torch.nonzero((occupancy.reshape(-1, 1) >> shifts) & 1,
                         as_tuple=True)
    s, j = q // C, q % C
    blocks = data.view(S, T // sub, sub, C * T // sub, sub)
    rows, cols, vals, keys = [], [], [], []
    for lo in range(0, q.numel(), _GATHER):
        sl = slice(lo, lo + _GATHER)
        s_, j_, i_, c_ = s[sl], j[sl], b[sl] // 8, b[sl] % 8
        tiles = blocks[s_, i_, :, j_ * 8 + c_, :]    # (m, 16, 16)
        m, rr, cc = torch.nonzero(tiles, as_tuple=True)
        s_, j_, i_, c_ = s_[m], j_[m], i_[m], c_[m]
        row = rowid[s_].long() * T + i_ * sub + rr
        rows.append(row)
        cols.append(cid[s_, j_].long() * T + c_ * sub + cc)
        vals.append(tiles[m, rr, cc])
        # Within a row: chunk, then strip column (slot, sub-block, column).
        keys.append((row * S + s_) * span + j_ * T + c_ * sub + cc)
    cat = (lambda xs, dt: torch.cat(xs) if xs
           else torch.zeros(0, dtype=dt, device=device))
    order = torch.argsort(cat(keys, torch.int64))
    row = cat(rows, torch.int64)[order]
    counts = torch.bincount(row, minlength=n_slices * SLICE)
    width = counts.view(n_slices, SLICE).amax(dim=1)
    slice_start = torch.zeros(n_slices + 1, dtype=torch.int64, device=device)
    slice_start[1:] = torch.cumsum(width * SLICE, 0)
    first = torch.cumsum(counts, 0) - counts       # each row's first entry
    rank = torch.arange(row.numel(), device=device) - first[row]
    dest = slice_start[row // SLICE] + rank * SLICE + row % SLICE
    L = int(slice_start[-1])
    val = torch.zeros(L, dtype=torch.float32, device=device)
    idx = torch.full((L,), -1, dtype=torch.int32, device=device)
    val[dest] = cat(vals, torch.float32)[order]
    idx[dest] = cat(cols, torch.int64)[order].int()
    return NarrowTable(val, idx, slice_start)


def _narrow_of(data, occupancy, rowid, cid, n_row_tiles):
    """The narrow table of fp32 strips with an occupancy table, else
    None."""
    if data.dtype != torch.float32 or occupancy is None:
        return None
    return narrow_table(data, occupancy, rowid, cid, n_row_tiles)


@dataclasses.dataclass(frozen=True)
class BSRTile:
    """Chunk-compact tile-sparse matrix (tile = 128).

    data:  (S*T, C*T) float32, or bfloat16 in 'bf16' mode
    cid:   (S, C) int32 — chunk slot -> column tile id
    rowid: (S,) int32, nondecreasing — chunk -> row tile
    nw:    (n_rt,) int32 — real (unpadded) nonempty tiles per row tile
    diag:  (n,) — the operator diagonal (solver preconditioners), in the
           build dtype
    gcid / lcid / gid: the group tables (None = no grouping), as in the
          JAX package
    first_chunk_of_row: (n_rt + 1,) int32 — row tile r owns chunks
          [first_chunk_of_row[r], first_chunk_of_row[r + 1])
    nv:    (S,) int32 — real (non-pad) slots of each chunk, a prefix
    static_layout: kept for layout compatibility with the JAX package,
          where it selects compile-time layout tables; here it only
          decides whether `from_scipy` builds group tables
    occupancy: (S, C) int64 — bit 8 i + j of a slot's word is set when
          the 16 x 16 sub-block (i, j) of its tile holds a nonzero
          (`occupancy_mask(data)`); the CUDA kernels need it
    narrow: the nonzeros of fp32 strips as a sliced ELL
          (`narrow_table`), which the narrow path reads; None with bf16
          strips

    Every array lives on one device. 'highest' and 'high' are both exact
    fp32 here; 'bf16' stores bf16 strips, rounds U to bf16 and
    accumulates in fp32, as the TPU kernels do.
    """

    data: torch.Tensor
    cid: torch.Tensor
    rowid: torch.Tensor
    nw: torch.Tensor
    diag: torch.Tensor
    n: int
    n_cols: int
    tile: int = 128
    transpose_bsr: "BSRTile | None" = None
    mxu_precision: str = "highest"
    static_layout: bool = True
    gcid: torch.Tensor | None = None
    lcid: torch.Tensor | None = None
    gid: torch.Tensor | None = None
    first_chunk_of_row: torch.Tensor | None = None
    nv: torch.Tensor | None = None
    occupancy: torch.Tensor | None = None
    narrow: NarrowTable | None = None

    def with_precision(self, precision: str) -> "BSRTile":
        """Same operator, another precision mode. 'bf16' stores a bf16
        copy of the strips; the other modes keep (or restore, as an
        upcast that keeps the bf16 rounding) fp32 strips. The occupancy
        table is kept: rounding to bf16 can only turn a nonzero into a
        zero, and the upcast turns none, so the table of the source
        strips covers every nonzero of the copy. The narrow table goes
        with the strips: kept with the same fp32 strips, rebuilt from
        converted fp32 strips, None with bf16 ones."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        t = (None if self.transpose_bsr is None
             else self.transpose_bsr.with_precision(precision))
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        data = self.data.to(dtype)
        narrow = self.narrow
        if data is not self.data:
            narrow = _narrow_of(data, self.occupancy, self.rowid, self.cid,
                                self.n_row_tiles)
        return dataclasses.replace(self, data=data, mxu_precision=precision,
                                   transpose_bsr=t, narrow=narrow)

    @functools.cached_property
    def _kernel_ready(self) -> bool:
        """Checks once per operator object what the CUDA kernels need of
        it (raises ValueError, and again at the next launch, on a
        malformed operator); True once it holds."""
        _check_operator(self)
        return True

    @property
    def shape(self):
        return (self.n, self.n_cols)

    @property
    def chunk(self) -> int:
        """Tiles per chunk (C)."""
        return self.cid.shape[1]

    @property
    def n_chunks(self) -> int:
        return self.cid.shape[0]

    @property
    def n_row_tiles(self) -> int:
        return self.nw.shape[0]

    @property
    def strip_w(self) -> int:
        """Max real nonempty tiles in any row tile (diagnostic)."""
        return max(int(self.nw.max()), 1)

    @property
    def n_slots(self) -> int:
        """Real (unpadded) nonempty tiles."""
        return int(self.nw.sum())

    def diagonal(self) -> torch.Tensor:
        return self.diag

    @classmethod
    def from_scipy(cls, A, dtype=torch.float32, device="cuda",
                   tile: int = 128, reorder: bool = True,
                   with_transpose: bool = True,
                   pad_rows_to: int | None = None,
                   pad_chunks_to: int | None = None,
                   perm: np.ndarray | None = None,
                   static_layout: bool = True, chunk: int = 8,
                   group: int = 32):
        """Convert a scipy sparse matrix; returns (op, perm). No bandwidth
        cap: any sparsity pattern tiles.

        `pad_rows_to` / `pad_chunks_to` force the row count and the chunk
        count up (pad chunks are zero tiles of the last row tile); `perm`
        supplies a precomputed ordering; `group` is the row tiles per
        gather group (0: no group tables). The layout tables are built on
        the host; `data` is scattered on `device` from the nonzero
        triplets, so the strips are never materialized on the host."""
        A = A.tocsr()
        A.sum_duplicates()
        n, n_cols = A.shape
        if perm is not None:
            perm = np.asarray(perm)
            Ap = A[perm][:, perm].tocsr()
        elif reorder:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
            Ap = A[perm][:, perm].tocsr()
        else:
            perm = np.arange(n)
            Ap = A

        if pad_rows_to is not None and pad_rows_to > n:
            # Empty rows/cols: zero K and M rows are inert in the solvers.
            extra = pad_rows_to - n
            Ap = sp.csr_matrix(
                (Ap.data, Ap.indices,
                 np.concatenate([Ap.indptr, np.full(extra, Ap.indptr[-1])])),
                shape=(pad_rows_to, pad_rows_to))
            n = n_cols = pad_rows_to

        coo = Ap.tocoo()
        T, C = tile, int(chunk)
        n_rt = -(-n // T)
        n_ct = -(-n_cols // T)
        key = (coo.row // T).astype(np.int64) * n_ct + coo.col // T
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        tile_key = np.unique(key_s)
        t_rt = (tile_key // n_ct).astype(np.int64)
        t_ct = (tile_key % n_ct).astype(np.int64)
        nw = np.bincount(t_rt, minlength=n_rt).astype(np.int32)
        # Chunks per row tile: >= 1, so every output row tile is written.
        cpr = np.maximum(-(-nw // C), 1)
        S = int(cpr.sum())
        if pad_chunks_to is not None:
            if pad_chunks_to < S:
                raise ValueError(
                    f"pad_chunks_to={pad_chunks_to} < required {S}")
            cpr[-1] += pad_chunks_to - S
            S = int(pad_chunks_to)
        chunk_start = np.concatenate(([0], np.cumsum(cpr)))   # (n_rt+1,)
        rowid = np.repeat(np.arange(n_rt, dtype=np.int32), cpr)

        # Slot of each nonempty tile in its row tile, split into (chunk,
        # within-chunk) coordinates.
        slot_in_row = np.arange(tile_key.shape[0]) - np.concatenate(
            ([0], np.cumsum(nw)))[t_rt]
        t_chunk = chunk_start[t_rt] + slot_in_row // C
        t_slot = slot_in_row % C

        # Pad slots repeat a valid column id of the same row tile.
        cid = np.zeros((S, C), np.int32)
        fallback = np.zeros(n_rt, np.int32)
        fallback[t_rt] = t_ct.astype(np.int32)
        cid[:] = fallback[rowid][:, None]
        cid[t_chunk, t_slot] = t_ct.astype(np.int32)

        gcid = lcid = gid = None
        G = int(group)
        if static_layout and G > 0:
            while True:
                gid_try = (rowid // max(G, 1)).astype(np.int32)
                n_groups = int(gid_try[-1]) + 1 if S else 1
                unions = [np.unique(cid[gid_try == g])
                          for g in range(n_groups)]
                C_u = max((u.shape[0] for u in unions), default=1)
                if C_u <= 64 or G == 1:
                    break
                G //= 2
            if C_u <= 64:
                gid = gid_try
                gcid = np.zeros((n_groups, C_u), np.int32)
                lcid = np.zeros((S, C), np.int32)
                for g, u in enumerate(unions):
                    gcid[g, :u.shape[0]] = u
                    gcid[g, u.shape[0]:] = u[0]
                    sel = gid == g
                    lcid[sel] = np.searchsorted(u, cid[sel]).astype(np.int32)

        # Real (non-pad) slots per chunk: slots fill a row tile's chunks
        # in order, so chunk s of row tile r holds
        # clip(nw[r] - (s - chunk_start[r]) * C, 0, C) of them.
        slot0 = (np.arange(S) - chunk_start[rowid]) * C
        nv = np.clip(nw[rowid] - slot0, 0, C).astype(np.int32)

        slot_of_entry = np.searchsorted(tile_key, key_s)
        d_rows = t_chunk[slot_of_entry] * T + coo.row[order] % T
        d_cols = t_slot[slot_of_entry] * T + coo.col[order] % T
        device = torch.device(device)
        data = torch.zeros((S * T, C * T), dtype=torch.float32, device=device)
        data[torch.as_tensor(d_rows, device=device),
             torch.as_tensor(d_cols, device=device)] = torch.as_tensor(
                 coo.data[order], dtype=torch.float32, device=device)
        data = data.to(dtype)
        # From the strips as stored (the bf16 ones for a bf16 build).
        occupancy = occupancy_mask(data) if T == 128 else None
        rowid_d = torch.as_tensor(rowid, device=device)
        cid_d = torch.as_tensor(cid, device=device)
        narrow = _narrow_of(data, occupancy, rowid_d, cid_d, n_rt)
        diag = torch.as_tensor(np.asarray(Ap.diagonal()), dtype=dtype,
                               device=device)

        transpose = None
        if with_transpose:
            d = (Ap - Ap.T).tocsr()
            if d.nnz and abs(d).max() > 1e-12 * max(abs(Ap).max(), 1e-300):
                if pad_chunks_to is not None:
                    raise NotImplementedError(
                        "pad_chunks_to with a nonsymmetric operator: "
                        "family padding of the transpose is not "
                        "supported; pass with_transpose=False or use "
                        "symmetric operators")
                transpose = cls.from_scipy(
                    Ap.T.tocsr(), dtype=dtype, device=device, tile=tile,
                    reorder=False, with_transpose=False,
                    static_layout=static_layout, pad_rows_to=pad_rows_to,
                    chunk=C, group=group)[0]

        def dev(a):
            return None if a is None else torch.as_tensor(a, device=device)

        precision = "bf16" if dtype == torch.bfloat16 else "highest"
        op = cls(data, cid_d, rowid_d, dev(nw), diag, n, n_cols, T,
                 transpose, precision, static_layout, dev(gcid), dev(lcid),
                 dev(gid), dev(chunk_start.astype(np.int32)), dev(nv),
                 occupancy, narrow)
        return op, perm


# ---- plain torch version (CPU tensors, and the kernels' oracle) ---------

def bsr_spmm_plain(A: BSRTile, U: torch.Tensor) -> torch.Tensor:
    """A @ U in fp32 the JAX reference's way: gather each chunk's U tiles
    by `cid`, one batched product per chunk, then sum the chunks of each
    row tile. 'bf16' rounds U to bf16 first, as the kernels do."""
    T, C, S = A.tile, A.chunk, A.n_chunks
    k = U.shape[1]
    Uf = U.float()
    if A.mxu_precision == "bf16":
        Uf = Uf.bfloat16().float()
    n_ct = -(-A.n_cols // T)
    Up = torch.nn.functional.pad(Uf, (0, 0, 0, n_ct * T - U.shape[0]))
    strips_u = Up.view(n_ct, T, k)[A.cid.long()].view(S, C * T, k)
    partial = torch.bmm(A.data.float().view(S, T, C * T), strips_u)
    out = torch.zeros((A.n_row_tiles, T, k), dtype=torch.float32,
                      device=U.device)
    out = out.index_add(0, A.rowid.long(), partial)
    return out.view(-1, k)[: A.n].to(U.dtype)


def narrow_spmm_plain(A: BSRTile, U: torch.Tensor) -> torch.Tensor:
    """A @ U in fp32 read from the operator's narrow table (the narrow
    kernel's layout), summed by `index_add_` in no fixed order."""
    t = A.narrow
    k = U.shape[1]
    width = (t.slice_start[1:] - t.slice_start[:-1]) // SLICE
    slice_of = torch.repeat_interleave(
        torch.arange(t.n_slices, device=U.device), width * SLICE)
    e = torch.arange(t.val.numel(), device=U.device)
    row = slice_of * SLICE + (e - t.slice_start[slice_of]) % SLICE
    live = t.idx >= 0
    out = torch.zeros((t.n_slices * SLICE, k), dtype=torch.float32,
                      device=U.device)
    out.index_add_(0, row[live],
                   t.val[live, None] * U.float()[t.idx[live].long()])
    return out[: A.n].to(U.dtype)


# ---- CUDA kernel wrappers ------------------------------------------------

@functools.cache
def build_kernel() -> ctypes.CDLL:
    """Compile csrc/bsr_spmm.cu (once per source hash), load it and
    declare its C interface."""
    from eigenpinns_torch.utils.cuda_build import load_library

    lib = load_library("bsr_spmm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.epk_bsr_spmm.restype = i
    lib.epk_bsr_spmm.argtypes = [p, i, p, p, p, p, p, i, i, i, p, p, i, i,
                                 i, i, i, i, p]
    lib.epk_bsr_spmm_narrow.restype = i
    lib.epk_bsr_spmm_narrow.argtypes = [p, p, p, i, p, p, i, i, p]
    lib.epk_bsr_error_string.restype = ctypes.c_char_p
    lib.epk_bsr_error_string.argtypes = [i]
    return lib


def walk_grid(A: BSRTile, k: int, col_block: int | None = None) -> tuple:
    """(col_block, warps) of the column-block walk for a product of width
    k: `default_col_block` and 8 stripes (warps) a block, unless row
    tiles x column blocks give fewer than two blocks an SM of the card.
    Then the column block falls to 32 (half the work a warp) and the
    block to the most warps, 4 or 2, that give two blocks an SM, or 2.
    Every choice gives the same bits. An explicit `col_block` is kept."""
    want = 2 * _sm_count(A.data.device)
    if col_block is None:
        col_block = default_col_block(k, A.data.dtype)
        if A.n_row_tiles * -(-k // col_block) < want:
            col_block = 32
    blocks = A.n_row_tiles * -(-k // col_block)
    warps = 8 if blocks >= want else 4 if 2 * blocks >= want else 2
    return col_block, warps


def _check_operator(A: BSRTile) -> None:
    """Raises ValueError when the kernels cannot take A."""
    data = A.data
    if not data.is_cuda:
        raise ValueError("the BSR kernels need the strips on a CUDA device, "
                         f"got {data.device}")
    want = torch.bfloat16 if A.mxu_precision == "bf16" else torch.float32
    if data.dtype != want:
        raise ValueError(f"'{A.mxu_precision}' needs {want} strips, got "
                         f"{data.dtype}")
    if A.tile != 128:
        raise ValueError(f"the BSR kernels take 128-wide tiles, got {A.tile}")
    if not (data.is_contiguous() and data.data_ptr() % 16 == 0):
        raise ValueError("the strips must be contiguous and 16-byte aligned")
    if A.n_row_tiles > 65535:
        raise ValueError("the BSR kernels take at most 65535 row tiles")
    occ = A.occupancy
    if (occ.dtype != torch.int64 or occ.shape != A.cid.shape
            or occ.device != data.device or not occ.is_contiguous()):
        raise ValueError("the occupancy table must be contiguous int64 "
                         f"{tuple(A.cid.shape)} on the strips' device")
    tables = [A.cid, A.first_chunk_of_row]
    if A.gcid is not None:
        tables += [A.gcid, A.lcid, A.gid]
    if any(t.dtype != torch.int32 or t.device != data.device
           or not t.is_contiguous() for t in tables):
        raise ValueError("layout tables must be contiguous int32 on the "
                         "strips' device")
    t = A.narrow
    if t is not None and not (
            t.val.dtype == torch.float32 and t.idx.dtype == torch.int32
            and t.slice_start.dtype == torch.int64
            and t.val.shape == t.idx.shape
            and t.n_slices * SLICE >= A.n
            and all(x.device == data.device and x.is_contiguous()
                    for x in (t.val, t.idx, t.slice_start))):
        raise ValueError("the narrow table must hold contiguous float32 "
                         "values, int32 U rows and int64 slice starts for "
                         "every row, on the strips' device")


def _launch(A: BSRTile, U: torch.Tensor, grouped: bool,
            col_block: int | None = None,
            warps: int | None = None) -> torch.Tensor:
    if A.occupancy is None:
        raise ValueError("the BSR kernels need the operator's occupancy "
                         "table (BSRTile.from_scipy builds it; "
                         "occupancy_mask(data) for a hand-made operator)")
    if (U.dtype != torch.float32 or U.dim() != 2 or U.shape[0] != A.n_cols
            or U.shape[1] == 0):
        raise ValueError(f"U must be float32 ({A.n_cols}, k >= 1), got "
                         f"{U.dtype} {tuple(U.shape)}")
    k = U.shape[1]
    narrow = (col_block is None and k <= NARROW_MAX_K
              and A.data.dtype == torch.float32)
    if narrow and A.narrow is None:
        raise ValueError("the narrow path (fp32 strips, k <= "
                         f"{NARROW_MAX_K}) needs the operator's narrow "
                         "table (BSRTile.from_scipy and with_precision "
                         "build it; narrow_table(...) for a hand-made "
                         "operator)")
    if not (U.is_cuda and U.is_contiguous()):
        raise ValueError("the BSR kernels need U contiguous on a CUDA "
                         f"device, got {U.device}")
    if grouped and A.gcid is None:
        raise ValueError("the grouped kernel needs the group tables")
    A._kernel_ready  # checks A on its first launch; raises if malformed
    if U.device != A.data.device:
        raise ValueError("the BSR kernels need U and the strips on one CUDA "
                         f"device (got {U.device}, {A.data.device})")
    W = torch.empty((A.n, k), dtype=torch.float32, device=U.device)
    lib = build_kernel()
    # The raw handle of the current stream: building a torch Stream
    # object for it is a measurable share of a launch's host path.
    stream = torch._C._cuda_getCurrentRawStream(U.device.index)
    if narrow:
        t = A.narrow
        err = lib.epk_bsr_spmm_narrow(
            t.val.data_ptr(), t.idx.data_ptr(), t.slice_start.data_ptr(),
            t.n_slices, U.data_ptr(), W.data_ptr(), A.n, k, stream)
    else:
        if col_block not in (None, 32, 64):
            raise ValueError(f"col_block must be 32 or 64, got {col_block}")
        col_block, grid = walk_grid(A, k, col_block)
        warps = grid if warps is None else warps
        if warps not in (2, 4, 8) or A.n_row_tiles * (8 // warps) > 65535:
            raise ValueError(f"warps must be 8, 4 or 2 (and row tiles x "
                             f"8 / warps <= 65535), got {warps}")
        col_tab = A.gcid if grouped else A.cid
        err = lib.epk_bsr_spmm(
            A.data.data_ptr(), int(A.data.dtype == torch.bfloat16),
            col_tab.data_ptr(), A.lcid.data_ptr() if grouped else None,
            A.gid.data_ptr() if grouped else None, A.occupancy.data_ptr(),
            A.first_chunk_of_row.data_ptr(), int(grouped), A.chunk,
            A.gcid.shape[1] if grouped else 0, U.data_ptr(), W.data_ptr(),
            A.n, A.n_cols, A.n_row_tiles, k, col_block, warps, stream)
    if err != 0:
        raise RuntimeError("bsr_spmm kernel launch failed: "
                           + lib.epk_bsr_error_string(err).decode())
    bsr_kernel_launches["grouped" if grouped else "burst"] += 1
    bsr_kernel_launches["narrow"] += narrow
    return W


def bsr_spmm_grouped_cuda(A: BSRTile, U: torch.Tensor,
                          col_block: int | None = None,
                          warps: int | None = None) -> torch.Tensor:
    """Launch the grouped kernel (port of `bsr_spmm_pallas_grouped`):
    column tiles through `gcid`/`lcid`/`gid`, occupied sub-blocks only.
    With `col_block` None, fp32 strips and k <= NARROW_MAX_K take the
    narrow path (the same bits); otherwise `col_block` (32 or 64 output
    columns per block) and `warps` (stripes per block: 8, 4 or 2) default
    to `walk_grid`'s; every choice gives the same bits."""
    return _launch(A, U, grouped=True, col_block=col_block, warps=warps)


def bsr_spmm_burst_cuda(A: BSRTile, U: torch.Tensor,
                        col_block: int | None = None,
                        warps: int | None = None) -> torch.Tensor:
    """Launch the burst kernel (port of `bsr_spmm_pallas`): column tiles
    through `cid`, occupied sub-blocks only (a pad slot costs the read of
    its empty occupancy word); the narrow path, `col_block` and `warps`
    as in `bsr_spmm_grouped_cuda`."""
    return _launch(A, U, grouped=False, col_block=col_block, warps=warps)


def _impl(A: BSRTile, U: torch.Tensor) -> torch.Tensor:
    # The JAX dispatcher also checked that the double-buffered union fits
    # the TPU's VMEM (`_grouped_ok`: 12 MB with k padded to 128 lanes).
    # The CUDA kernels stage no union, so that budget has no counterpart:
    # the group tables alone select the grouped kernel.
    if U.is_cuda:
        if A.gcid is not None:
            return bsr_spmm_grouped_cuda(A, U.contiguous())
        return bsr_spmm_burst_cuda(A, U.contiguous())
    return bsr_spmm_plain(A, U)


def bsr_spmm_hbm_bytes(A: BSRTile, k: int) -> int:
    """Bytes one `bsr_spmm(A, U)` with an (n_cols, k) fp32 U moves through
    the kernel `_impl` dispatches. The narrow path (fp32 strips, k <=
    NARROW_MAX_K): every entry of the narrow table, padding included (a
    4-byte value and a 4-byte U row), the slice starts, each nonzero's U
    row (k fp32) and W written once. The column-block walk: for every
    occupied 16 x 16 sub-block, its 256 strip values and the 16 x k fp32
    U rows it multiplies; for every slot, pad slots too, its 8-byte
    occupancy word and its 4-byte column entry (`cid`, or `lcid` with the
    group tables `gcid` and `gid` on top); then `first_chunk_of_row`, and
    W written once. A sub-block and its U rows count once per product:
    the column blocks of a row tile are launched next to each other and
    share them through L2. No lane padding: the kernels mask k."""
    if A.data.dtype == torch.float32 and k <= NARROW_MAX_K:
        t = A.narrow
        return int(t.val.numel() * 8 + t.slice_start.numel() * 8
                   + t.nnz * k * 4 + A.n * k * 4)
    sub_b = 16 * 16 * A.data.element_size() + 16 * k * 4
    tables = A.n_chunks * A.chunk * (8 + 4) + (A.n_row_tiles + 1) * 4
    if A.gcid is not None:
        tables += A.gcid.numel() * 4 + A.gid.numel() * 4
    return int(occupied_blocks(A.occupancy) * sub_b + tables + A.n * k * 4)


class _BsrSpmm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, U, A):
        ctx.A = A
        return _impl(A, U)

    @staticmethod
    def backward(ctx, g):
        A = ctx.A
        At = A.transpose_bsr if A.transpose_bsr is not None else A
        return _impl(At, g), None


def bsr_spmm(A: BSRTile, U: torch.Tensor) -> torch.Tensor:
    """A @ U; the backward pass applies A^T through the same kernels.
    Without a gradient to take (the solvers' products under no_grad) the
    autograd node is skipped: its host cost is part of every launch."""
    if not (U.requires_grad and torch.is_grad_enabled()):
        return _impl(A, U)
    return _BsrSpmm.apply(U, A)


def bsr_spmm_gram(A: BSRTile, U: torch.Tensor):
    """(A @ U, U^T A U). The Gram is a plain fp32 matmul epilogue, as in
    the JAX package; its gradient comes from the matmul's autograd."""
    W = bsr_spmm(A, U)
    return W, U.T @ W
