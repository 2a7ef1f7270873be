"""Distributed banded operators: ring-halo exchange + per-shard K4.

Port of `eigenpinns_tpu/parallel/sharded_banded.py`, the production
sharded SpMM for mesh and cloud Laplacians:

  * rows are block-sharded over the mesh's data axis, `per` rows per
    rank, with the operator RCM-ordered so every nonzero of shard s's
    rows lies within the halo window [s per - B, (s + 1) per + B);
  * each SpMM exchanges one (B, k) halo slice per side on the ring
    (`sharded.ring_exchange`), then runs the shard-local rectangular
    (per x per + 2B) banded block through K4 (`sparse/banded.py`) on the
    window [left halo | own rows | right halo];
  * the backward pass applies the prebuilt banded transpose block of
    each shard, (win_pad x per), through K4 as well, and the ring
    exchange's backward pass sends the halo cotangents back to their
    source shards: no gathers or scatters;
  * cluster-split operators add their sparse remainder through an
    all-gathered gather-ELL term (plain torch, as XLA's gather is in the
    JAX package: no hand kernel), so the 1M-point split operator runs
    sharded end to end.

The host tables are the JAX package's, byte for byte. `from_scipy` makes
the dense band of the shards it is asked for only (`shards`; default:
all), on `device`: each rank of a mesh holds its own block.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from eigenpinns_torch.parallel.mesh import Mesh
from eigenpinns_torch.parallel.sharded import (
    _all_gather,
    local_gather_spmm,
    ring_exchange,
)
from eigenpinns_torch.sparse.banded import (
    BandedELL,
    _round_up,
    band_occupancy,
    banded_spmm,
    full_band_table,
    scatter_band,
)


def _tile_windows(indptr, indices, n_rows, tile):
    """Per-tile [min_col, max_col] windows of a CSR matrix (vectorized)."""
    n_pad = _round_up(max(n_rows, tile), tile)
    n_tiles = n_pad // tile
    tile_ptr = indptr[np.minimum(np.arange(0, n_pad + tile, tile), n_rows)]
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
    return starts, ends, n_pad, n_tiles


def _rect_banded(A_csr, tile: int, bandwidth: int | None = None,
                 dtype=torch.float32, device="cpu"):
    """Band a rectangular CSR block (no reordering, explicit n_cols).

    Returns (band tensor on `device`, starts int32, B); `bandwidth`
    forces a common B so per-shard blocks stack into one array."""
    n_rows, n_cols = A_csr.shape
    indptr, indices, data = A_csr.indptr, A_csr.indices, A_csr.data
    starts, ends, n_pad, _ = _tile_windows(indptr, indices, n_rows, tile)
    spread = int((ends - starts + 1).max()) if starts.size else 1
    B = bandwidth if bandwidth is not None else _round_up(
        max(spread, 128), 128)
    if spread > B:
        raise ValueError(f"tile spread {spread} exceeds bandwidth {B}")
    starts = np.minimum(starts, max(n_cols - 1, 0)).astype(np.int64)
    deg = np.diff(indptr)
    rows = np.repeat(np.arange(n_rows), deg)
    local = indices - starts[rows // tile]
    band = scatter_band(rows, local, data, (n_pad, B), dtype, device)
    return band, starts.astype(np.int32), B


@dataclasses.dataclass(frozen=True)
class ShardedBanded:
    """Row-sharded banded operator with per-shard transpose blocks.

    band:     (len(shards), per, B)   shard-local banded rows; column
              index relative to the shard's halo-window origin s per - B
    starts:   (len(shards), tiles) int32  per-tile window starts,
              window-relative
    band_t:   (len(shards), win_pad, B_t)  banded transpose of each
              local (per, win) block: rows = window rows, cols = local rows
    starts_t: (len(shards), tiles_t) int32
    shards:   the shards held, in order (all of them by default)
    n:        true (unpadded) global row count
    """

    band: torch.Tensor
    starts: torch.Tensor
    band_t: torch.Tensor
    starts_t: torch.Tensor
    shards: tuple
    n: int
    n_dev: int
    per: int
    B: int
    tile: int

    @property
    def n_pad(self) -> int:
        return self.n_dev * self.per

    @property
    def win(self) -> int:
        return self.per + 2 * self.B

    def diagonal(self) -> torch.Tensor:
        """Main diagonal of the held shards' rows (padded rows hold 0):
        shard s's row r is window column B + r."""
        rows = torch.arange(self.per, device=self.band.device)
        local = (self.B + rows)[None, :] - self.starts.long()[
            :, rows // self.tile]
        local = torch.clamp(local, 0, self.B - 1)
        d = torch.take_along_dim(self.band, local[:, :, None], dim=2)
        return d[:, :, 0].reshape(-1)

    def local(self, mesh: Mesh, axis: str = "data") -> BandedELL:
        """This rank's block (`block` of its shard, on the mesh's
        device)."""
        if self.n_dev != mesh.axis_size(axis):
            raise ValueError(f"operator for {self.n_dev} shards on an axis "
                             f"of {mesh.axis_size(axis)}")
        return self.block(mesh.axis_index(axis), mesh.device)

    def block(self, shard: int, device) -> BandedELL:
        """Shard `shard`'s (per x win) block as a BandedELL on `device`,
        its (win x per) transpose attached, with their occupancy tables
        and nonzero tables (`full_band_table`, which K4's row-wise route
        reads). The tables are built here, once per block: the sharded
        SpMM takes its block once per closure (`sharded_banded_spmm`)."""
        if shard not in self.shards:
            raise ValueError(f"shard {shard} was not built (held: "
                             f"{self.shards})")
        j = self.shards.index(shard)
        dev = torch.device(device)

        def banded(band, starts, n, n_cols, transpose=None):
            occ = band_occupancy(band, self.tile)
            return BandedELL(band, starts, n=n, n_cols=n_cols,
                             tile=self.tile, transpose_banded=transpose,
                             occupancy=occ,
                             narrow=full_band_table(band, occ, starts))

        A_t = banded(self.band_t[j].to(dev), self.starts_t[j].to(dev),
                     self.win, self.per)
        return banded(self.band[j].to(dev), self.starts[j].to(dev),
                      self.per, self.win, A_t)

    @classmethod
    def from_scipy(cls, A, n_dev: int, dtype=torch.float32, tile: int = 128,
                   reorder: bool = True, max_bandwidth: int = 4096,
                   shards=None, device="cuda"):
        """Shard a (numerically or structurally banded) operator; builds
        the bands of `shards` (default: all) on `device`.

        Returns (op, perm). Raises ValueError when the stencil cannot fit
        a one-neighbor halo (bandwidth > per) or exceeds max_bandwidth —
        callers fall back to all_gather paths."""
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        A = A.tocsr()
        A.sum_duplicates()
        n = A.shape[0]
        if reorder:
            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        else:
            perm = np.arange(n)
        Ap = A[perm][:, perm].tocsr()

        per = _round_up(-(-n // n_dev), tile)
        n_pad = per * n_dev
        if n_pad != n:
            Ap = sp.block_diag(
                [Ap, sp.csr_matrix((n_pad - n, n_pad - n))]).tocsr()

        starts_abs, ends_abs, _, _ = _tile_windows(
            Ap.indptr, Ap.indices, n_pad, tile)
        spread = int((ends_abs - starts_abs + 1).max()) if n_pad else 1
        B = _round_up(max(spread, 128), 128)
        if B > max_bandwidth:
            raise ValueError(
                f"post-RCM tile bandwidth {spread} exceeds max_bandwidth="
                f"{max_bandwidth}; use an all_gather/split path")
        if B > per:
            raise ValueError(
                f"bandwidth {B} exceeds rows-per-shard {per}: stencil "
                "crosses non-neighbor shards; use fewer devices or the "
                "all_gather path")
        win = per + 2 * B
        # Validate the one-neighbor halo invariant row-exactly: every
        # nonzero of shard s must fall in [s*per - B, (s+1)*per + B).
        coo = Ap.tocoo()
        s_of_row = coo.row // per
        lo = s_of_row * per - B
        if ((coo.col < lo) | (coo.col >= lo + win)).any():
            raise ValueError(
                "operator stencil crosses the one-neighbor halo window; "
                "reorder with RCM or use the all_gather path")

        shards = tuple(range(n_dev)) if shards is None else tuple(shards)
        blocks, blocks_t = [], []
        B_t_max = 128
        for s in range(n_dev):
            w0 = s * per - B
            block = Ap[s * per:(s + 1) * per, :].tocoo()
            blk = sp.csr_matrix((block.data, (block.row, block.col - w0)),
                                shape=(per, win))
            blk_t = blk.T.tocsr()
            stt, ent, _, _ = _tile_windows(
                blk_t.indptr, blk_t.indices, win, tile)
            spread_t = int((ent - stt + 1).max()) if stt.size else 1
            B_t_max = max(B_t_max, _round_up(max(spread_t, 128), 128))
            if s in shards:
                blocks.append(blk)
                blocks_t.append(blk_t)
        bands, starts_rel, bands_t, starts_t = [], [], [], []
        for blk, blk_t in zip(blocks, blocks_t):
            # Forward band: per-tile windows, clamped into the window.
            st, _, _, _ = _tile_windows(blk.indptr, blk.indices, per, tile)
            st = np.minimum(st, win - B)
            deg = np.diff(blk.indptr)
            r = np.repeat(np.arange(per), deg)
            bands.append(scatter_band(r, blk.indices - st[r // tile],
                                      blk.data, (per, B), dtype, device))
            starts_rel.append(st.astype(np.int32))
            bt, stt, _ = _rect_banded(blk_t, tile, bandwidth=B_t_max,
                                      dtype=dtype, device=device)
            bands_t.append(bt)
            starts_t.append(stt)

        dev = torch.device(device)
        op = cls(
            band=torch.stack(bands),
            starts=torch.as_tensor(np.stack(starts_rel), device=dev),
            band_t=torch.stack(bands_t),
            starts_t=torch.as_tensor(np.stack(starts_t), device=dev),
            shards=shards, n=n, n_dev=n_dev, per=per, B=B, tile=tile)
        return op, perm


def sharded_banded_spmm(op: ShardedBanded, mesh: Mesh, axis: str = "data"):
    """Build f(U local rows (per, k)) -> (A U) local rows.

    Two (B, k) ring messages + one shard-local K4 launch per application;
    differentiable (K4 on the prebuilt transpose block, the halo
    cotangents routed back by the ring's backward pass)."""
    A_loc = op.local(mesh, axis)
    B = op.B

    def apply(u):
        left, right = ring_exchange(u, B, mesh, axis)
        return banded_spmm(A_loc, torch.cat([left, u, right], dim=0))

    return apply


@dataclasses.dataclass(frozen=True)
class ShardedRemainder:
    """Row-sharded gather-ELL term applied against an all-gathered U.

    Carries the cluster-boundary entries of a SplitBanded operator whose
    columns cross non-neighbor shards. Values must be SYMMETRIC as a
    global matrix — the sharded split SpMM reuses the forward pass as its
    backward pass."""

    indices: np.ndarray   # (n_dev, per, W) int32 global columns
    values: np.ndarray    # (n_dev, per, W) float32
    n: int
    n_dev: int

    @classmethod
    def from_scipy(cls, R, n_dev: int, per: int, dtype=np.float32):
        R = R.tocsr()
        n = R.shape[0]
        n_pad = per * n_dev
        if n_pad != n:
            R = sp.block_diag(
                [R, sp.csr_matrix((n_pad - n, n_pad - n))]).tocsr()
        W = max(int(np.diff(R.indptr).max()) if R.nnz else 1, 1)
        idx = np.zeros((n_pad, W), dtype=np.int32)
        val = np.zeros((n_pad, W), dtype=np.float32)
        deg = np.diff(R.indptr)
        rows = np.repeat(np.arange(n_pad), deg)
        slot = np.arange(R.nnz) - np.repeat(R.indptr[:-1], deg)
        idx[rows, slot] = R.indices
        val[rows, slot] = R.data
        return cls(idx.reshape(n_dev, per, W),
                   val.reshape(n_dev, per, W).astype(dtype), n, n_dev)


class _SelfAdjoint(torch.autograd.Function):
    """fn applied to U; its backward pass applies fn to the cotangent
    (A symmetric => A^T g = A g)."""

    @staticmethod
    def forward(ctx, u, fn):
        ctx.fn = fn
        return fn(u)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g.contiguous()), None


def sharded_split_spmm(core: ShardedBanded, rem: ShardedRemainder | None,
                       mesh: Mesh, axis: str = "data"):
    """f(U local rows) -> (A_band + A_rem) U for a SYMMETRIC split
    operator. The core rides the halo path; the remainder all-gathers U
    (its columns cross clusters arbitrarily). The backward pass reapplies
    the forward pass: valid because SplitBanded.from_scipy enforces
    numeric symmetry."""
    core_apply = sharded_banded_spmm(core, mesh, axis)
    if rem is None:
        return core_apply
    i = mesh.axis_index(axis)
    idx = torch.as_tensor(rem.indices[i], dtype=torch.int64,
                          device=mesh.device)
    val = torch.as_tensor(rem.values[i], device=mesh.device)

    def forward(u):
        r = local_gather_spmm(idx, val, _all_gather(u, mesh, axis))
        return core_apply(u) + r

    def apply(u):
        return _SelfAdjoint.apply(u, forward)

    return apply


def _split_decompose(Ap, tile: int, window: int):
    """Core/remainder split of an (already ordered) CSR operator.

    Same symmetric rule as sparse/split.py: an entry stays in the banded
    core only if it fits its row's row-centered window AND its mirror
    fits the mirror row's window — keeping the core numerically
    symmetric for symmetric A. Returns (core_csr, rem_csr)."""
    n = Ap.shape[0]
    n_pad = _round_up(max(n, tile), tile)
    B = _round_up(min(window, n_pad), 128)
    t_ids = np.arange(n_pad // tile)
    starts = np.clip(t_ids * tile + tile // 2 - B // 2, 0,
                     max(n_pad - B, 0)).astype(np.int64)
    coo = Ap.tocoo()
    local = coo.col - starts[coo.row // tile]
    in_band = (local >= 0) & (local < B)
    local_m = coo.row - starts[coo.col // tile]
    in_band &= (local_m >= 0) & (local_m < B)
    core = sp.coo_matrix(
        (coo.data[in_band], (coo.row[in_band], coo.col[in_band])),
        shape=(n, n)).tocsr()
    rem = sp.coo_matrix(
        (coo.data[~in_band], (coo.row[~in_band], coo.col[~in_band])),
        shape=(n, n)).tocsr()
    rem.eliminate_zeros()
    return core, rem


def build_sharded_operator(A, n_dev: int, X=None, dtype=torch.float32,
                           tile: int = 128, max_bandwidth: int = 4096,
                           window: int = 1024, shards=None, device="cuda"):
    """Canonicalize a scipy operator for an n_dev-shard axis.

    Tries the pure halo-banded form first; falls back to the
    cluster-split form (banded core via halo + sparse remainder via
    all-gather) when the global RCM bandwidth is too wide — the 1M-point
    cloud regime. Bands are built for `shards` (default: all) on
    `device`. Returns (kind, (core, remainder_or_None), perm) with kind
    'banded' | 'split'; apply the perm to all node-indexed data."""
    try:
        op, perm = ShardedBanded.from_scipy(
            A, n_dev, dtype=dtype, tile=tile, max_bandwidth=max_bandwidth,
            shards=shards, device=device)
        return "banded", (op, None), perm
    except ValueError:
        pass

    if X is not None:
        from eigenpinns_torch.sparse.split import spatial_cluster_order

        n = A.shape[0]
        n_clusters = max(n_dev, int(np.ceil(n / max(window * 24, 1))))
        perm = spatial_cluster_order(np.asarray(X), n_clusters, adjacency=A)
    else:
        from scipy.sparse.csgraph import reverse_cuthill_mckee

        perm = np.asarray(reverse_cuthill_mckee(A.tocsr(),
                                                symmetric_mode=True))
    Ap = A.tocsr()[perm][:, perm].tocsr()
    # The banded core must satisfy the one-neighbor halo invariant, so
    # its window can never exceed the per-shard row count.
    per = _round_up(-(-A.shape[0] // n_dev), tile)
    window = min(window, per)
    core_sp, rem_sp = _split_decompose(Ap, tile, window)
    core_op, _ = ShardedBanded.from_scipy(
        core_sp, n_dev, dtype=dtype, tile=tile, reorder=False,
        max_bandwidth=max_bandwidth, shards=shards, device=device)
    rem = (ShardedRemainder.from_scipy(rem_sp, n_dev, core_op.per)
           if rem_sp.nnz else None)
    return "split", (core_op, rem), perm
