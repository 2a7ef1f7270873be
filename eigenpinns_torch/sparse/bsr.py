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
reads column tiles through the group tables and skips pad slots) when the
operator has group tables, the burst one (port of `bsr_spmm_pallas`,
which reads them through `cid` and multiplies every slot) otherwise. CPU
tensors take `bsr_spmm_plain`, the plain torch version of the same
function. A CUDA tensor always reaches a kernel or raises.

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

PRECISIONS = ("highest", "high", "bf16")

# Launches of each CUDA kernel (one per wrapper call that reaches it).
bsr_kernel_launches = {"grouped": 0, "burst": 0}


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

    def with_precision(self, precision: str) -> "BSRTile":
        """Same operator, another precision mode. 'bf16' stores a bf16
        copy of the strips; the other modes keep (or restore, as an
        upcast that keeps the bf16 rounding) fp32 strips."""
        if precision not in PRECISIONS:
            raise ValueError(f"precision must be one of {PRECISIONS}")
        t = (None if self.transpose_bsr is None
             else self.transpose_bsr.with_precision(precision))
        dtype = torch.bfloat16 if precision == "bf16" else torch.float32
        return dataclasses.replace(self, data=self.data.to(dtype),
                                   mxu_precision=precision, transpose_bsr=t)

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
        op = cls(data, dev(cid), dev(rowid), dev(nw), diag, n, n_cols, T,
                 transpose, precision, static_layout, dev(gcid), dev(lcid),
                 dev(gid), dev(chunk_start.astype(np.int32)), dev(nv))
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
                                 i, i, p]
    lib.epk_bsr_error_string.restype = ctypes.c_char_p
    lib.epk_bsr_error_string.argtypes = [i]
    return lib


def _launch(A: BSRTile, U: torch.Tensor, grouped: bool) -> torch.Tensor:
    data = A.data
    if not (U.is_cuda and data.is_cuda and U.device == data.device):
        raise ValueError("the BSR kernels need U and the strips on one CUDA "
                         f"device (got {U.device}, {data.device})")
    want = torch.bfloat16 if A.mxu_precision == "bf16" else torch.float32
    if data.dtype != want:
        raise ValueError(f"'{A.mxu_precision}' needs {want} strips, got "
                         f"{data.dtype}")
    if U.dtype != torch.float32 or U.dim() != 2 or U.shape[0] != A.n_cols:
        raise ValueError(f"U must be float32 ({A.n_cols}, k), got {U.dtype} "
                         f"{tuple(U.shape)}")
    if A.tile != 128:
        raise ValueError(f"the BSR kernels take 128-wide tiles, got {A.tile}")
    if grouped and A.gcid is None:
        raise ValueError("the grouped kernel needs the group tables")
    if not (data.is_contiguous() and U.is_contiguous()
            and data.data_ptr() % 16 == 0):
        raise ValueError("the strips must be contiguous and 16-byte "
                         "aligned, U contiguous")
    if A.n_row_tiles > 65535:
        raise ValueError("the BSR kernels take at most 65535 row tiles")
    tables = [A.cid, A.nv, A.first_chunk_of_row]
    if grouped:
        tables += [A.gcid, A.lcid, A.gid]
    if any(t.dtype != torch.int32 or t.device != data.device
           or not t.is_contiguous() for t in tables):
        raise ValueError("layout tables must be contiguous int32 on the "
                         "strips' device")
    k = U.shape[1]
    W = torch.empty((A.n, k), dtype=torch.float32, device=U.device)
    lib = build_kernel()
    stream = torch.cuda.current_stream(U.device).cuda_stream
    col_tab = A.gcid if grouped else A.cid
    err = lib.epk_bsr_spmm(
        data.data_ptr(), int(data.dtype == torch.bfloat16),
        col_tab.data_ptr(), A.lcid.data_ptr() if grouped else None,
        A.gid.data_ptr() if grouped else None, A.nv.data_ptr(),
        A.first_chunk_of_row.data_ptr(), int(grouped), A.chunk,
        A.gcid.shape[1] if grouped else 0, U.data_ptr(), W.data_ptr(),
        A.n, A.n_cols, A.n_row_tiles, k, stream)
    if err != 0:
        raise RuntimeError("bsr_spmm kernel launch failed: "
                           + lib.epk_bsr_error_string(err).decode())
    bsr_kernel_launches["grouped" if grouped else "burst"] += 1
    return W


def bsr_spmm_grouped_cuda(A: BSRTile, U: torch.Tensor) -> torch.Tensor:
    """Launch the grouped kernel (port of `bsr_spmm_pallas_grouped`):
    column tiles through `gcid`/`lcid`/`gid`, pad slots skipped."""
    return _launch(A, U, grouped=True)


def bsr_spmm_burst_cuda(A: BSRTile, U: torch.Tensor) -> torch.Tensor:
    """Launch the burst kernel (port of `bsr_spmm_pallas`): column tiles
    through `cid`, every slot of every chunk."""
    return _launch(A, U, grouped=False)


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
    the kernel `_impl` dispatches: the strip tiles it reads (the grouped
    kernel reads only real slots, the burst kernel every slot), one
    (T, k) U tile per slot read, and W. The strip counts once per row
    tile: the column blocks of a row tile are launched next to each other
    and share it through L2. No lane padding: the kernels mask k."""
    tile_b = A.tile * A.tile * A.data.element_size()
    slots = A.n_slots if A.gcid is not None else A.n_chunks * A.chunk
    return int(slots * (tile_b + A.tile * k * 4) + A.n * k * 4)


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
    """A @ U; the backward pass applies A^T through the same kernels."""
    return _BsrSpmm.apply(U, A)


def bsr_spmm_gram(A: BSRTile, U: torch.Tensor):
    """(A @ U, U^T A U). The Gram is a plain fp32 matmul epilogue, as in
    the JAX package; its gradient comes from the matmul's autograd."""
    W = bsr_spmm(A, U)
    return W, U.T @ W
