"""Split operators: banded core + sparse remainder, for large clouds.

Port of `eigenpinns_tpu/sparse/split.py`. A locality ordering of the
nodes (FPS clusters with RCM inside each, or a Hilbert curve) makes most
of a surface cloud's Laplacian fall inside a narrow per-tile window. The
operator is decomposed as

    A = A_band + A_rem

where A_band holds every entry inside a capped, row-centred window of
each 128-row tile (a `BandedELL` core: kernels K4/K5 of
`csrc/banded_spmm.cu`) and A_rem the few entries outside it (a
`SparseELL`, gather SpMM with its scatter-free backward pass). The host
layout is the JAX package's, byte for byte; the orderings are numpy
copies of its host code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eigenpinns_torch.sparse.banded import (
    BandedELL,
    _round_up,
    band_occupancy,
    banded_spmm,
    banded_spmm_gram,
    scatter_band,
)
from eigenpinns_torch.sparse.formats import SparseELL


def hilbert_order(X: np.ndarray, bits: int = 16) -> np.ndarray:
    """Permutation sorting points along a 3D Hilbert curve (vectorized
    Skilling transform: Gray decode + per-bit exchange/invert, then bit
    interleave). On surface clouds it keeps the kNN index spread small, so
    a capped window (512) captures most of the nnz."""
    X = np.asarray(X, dtype=np.float64)
    Xq = X - X.min(0)
    scale = Xq.max()
    if scale <= 0:
        return np.arange(X.shape[0], dtype=np.int64)
    Xq = (Xq / scale * ((1 << bits) - 1)).astype(np.uint64)
    c = Xq.T.copy()  # (3, N) axis-major coordinates
    n_ax = 3
    top = np.uint64(1) << np.uint64(bits - 1)
    q = top
    while q > np.uint64(1):
        p = q - np.uint64(1)
        for i in range(n_ax):
            mask = (c[i] & q) > 0
            c[0][mask] ^= p
            t = (c[0] ^ c[i]) & p
            c[0][~mask] ^= t[~mask]
            c[i][~mask] ^= t[~mask]
        q >>= np.uint64(1)
    for i in range(1, n_ax):
        c[i] ^= c[i - 1]
    t = np.zeros(c.shape[1], dtype=np.uint64)
    q = top
    while q > np.uint64(1):
        mask = (c[n_ax - 1] & q) > 0
        t[mask] ^= q - np.uint64(1)
        q >>= np.uint64(1)
    for i in range(n_ax):
        c[i] ^= t
    key = np.zeros(c.shape[1], dtype=np.uint64)
    for b in range(bits - 1, -1, -1):
        for i in range(n_ax):
            key = (key << np.uint64(1)) | ((c[i] >> np.uint64(b))
                                           & np.uint64(1))
    return np.argsort(key, kind="stable")


def spatial_cluster_order(X: np.ndarray, n_clusters: int,
                          adjacency=None) -> np.ndarray:
    """Permutation grouping nodes into spatially contiguous clusters: FPS
    centers, nearest-center assignment, then (with `adjacency`) RCM inside
    each cluster. Returns perm such that X[perm] is cluster-contiguous."""
    import scipy.sparse as sp
    from scipy.sparse.csgraph import reverse_cuthill_mckee
    from scipy.spatial import cKDTree

    from eigenpinns_torch.sampling.samplers import farthest_point_indices

    n = X.shape[0]
    centers = farthest_point_indices(X, min(n_clusters, n), seed=0)
    _, assign = cKDTree(X[centers]).query(X, k=1)
    # One global cluster-sort, then per-cluster RCM on diagonal blocks
    # extracted from COO by range masks.
    order0 = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order0], np.arange(len(centers) + 1))
    perm = order0.copy()
    if adjacency is not None:
        inv = np.empty(n, dtype=np.int64)
        inv[order0] = np.arange(n)
        coo = adjacency.tocoo()
        r = inv[coo.row]
        c = inv[coo.col]
        cluster_of = np.searchsorted(bounds, r, side="right") - 1
        same = cluster_of == (np.searchsorted(bounds, c, side="right") - 1)
        rs, cs, ds = r[same], c[same], coo.data[same]
        for ci in range(len(centers)):
            lo, hi = bounds[ci], bounds[ci + 1]
            m = hi - lo
            if m <= 2:
                continue
            sel = (rs >= lo) & (rs < hi)
            block = sp.coo_matrix(
                (ds[sel], (rs[sel] - lo, cs[sel] - lo)),
                shape=(m, m)).tocsr()
            local = np.asarray(reverse_cuthill_mckee(
                block, symmetric_mode=True))
            perm[lo:hi] = order0[lo:hi][local]
    return perm


@dataclasses.dataclass(frozen=True)
class SplitBanded:
    """A = banded core (BandedELL) + ELL remainder (SparseELL | None)."""

    core: BandedELL
    remainder: SparseELL | None

    @property
    def shape(self):
        return self.core.shape

    @property
    def n(self):
        return self.core.n

    def diagonal(self) -> torch.Tensor:
        d = self.core.diagonal()
        if self.remainder is not None:
            d = d + self.remainder.diagonal()
        return d

    @classmethod
    def from_scipy(cls, A, X: np.ndarray | None = None,
                   dtype=torch.float32, device="cuda", tile: int = 128,
                   window: int = 1024, n_clusters: int | None = None,
                   order: str | np.ndarray = "cluster"):
        """Decompose a (pre-permutation) symmetric operator; returns
        (op, perm), op = P A P^T.

        With X, `order` picks the ordering: 'cluster' (FPS centers +
        per-cluster RCM, the spectral-basis default), 'hilbert' (pairs
        with a small `window` for training operators) or an explicit
        permutation array; without X, global RCM. `window` caps the
        core's width; everything outside it lands in the remainder, which
        stays fp32 even for a bf16 core. The band is scattered on
        `device`."""
        import scipy.sparse as sp

        A = A.tocsr()
        A.sum_duplicates()
        n = A.shape[0]
        # The core's backward pass applies the core itself as A^T, and the
        # remainder's mirror entries may land in the core: both need
        # NUMERIC symmetry.
        d = (A - A.T).tocsr()
        if d.nnz and abs(d).max() > 1e-6 * max(abs(A).max(), 1e-300):
            raise ValueError(
                "SplitBanded requires a numerically symmetric operator "
                f"(max |A - A^T| = {abs(d).max():.3g}); use "
                "SparseELL/BandedELL.from_scipy, which attach an explicit "
                "transpose for the backward pass")
        if isinstance(order, np.ndarray):
            perm = np.asarray(order, dtype=np.int64)
            if perm.shape != (n,):
                raise ValueError(
                    f"explicit order has shape {perm.shape}, expected ({n},)")
        elif X is not None and order == "hilbert":
            perm = hilbert_order(np.asarray(X))
        elif X is not None:
            if order != "cluster":
                raise ValueError(f"unknown order {order!r}")
            if n_clusters is None:
                n_clusters = max(1, int(np.ceil(n / max(window * 24, 1))))
                n_clusters = max(n_clusters, int(np.ceil(n / 100_000)))
            perm = spatial_cluster_order(np.asarray(X), n_clusters,
                                         adjacency=A)
        else:
            from scipy.sparse.csgraph import reverse_cuthill_mckee

            perm = np.asarray(reverse_cuthill_mckee(A, symmetric_mode=True))
        Ap = A[perm][:, perm].tocsr()

        n_pad = _round_up(max(n, tile), tile)
        B = _round_up(min(window, n_pad), 128)
        # Row-centred windows keep the diagonal inside every window.
        t_ids = np.arange(n_pad // tile)
        starts = np.clip(t_ids * tile + tile // 2 - B // 2, 0,
                         max(n_pad - B, 0)).astype(np.int64)

        coo = Ap.tocoo()
        local = coo.col - starts[coo.row // tile]
        in_band = (local >= 0) & (local < B)
        # Keep the core symmetric: an entry stays in the band only if its
        # mirror (j, i) also fits its own tile's window.
        local_m = coo.row - starts[coo.col // tile]
        in_band &= (local_m >= 0) & (local_m < B)

        band = scatter_band(coo.row[in_band], local[in_band],
                            coo.data[in_band], (n_pad, B), dtype, device)
        core = BandedELL(band, torch.as_tensor(starts.astype(np.int32),
                                               device=band.device),
                         n, n, tile, occupancy=band_occupancy(band, tile))

        remainder = None
        if int((~in_band).sum()):
            rem = sp.coo_matrix(
                (coo.data[~in_band],
                 (coo.row[~in_band], coo.col[~in_band])),
                shape=(n, n)).tocsr()
            # The remainder is a few % of nnz: keep it fp32 even for a
            # bf16 core.
            rem_dtype = torch.float32 if dtype == torch.bfloat16 else dtype
            remainder = SparseELL.from_scipy(rem, dtype=rem_dtype,
                                             device=device)
        return cls(core, remainder), perm

    @property
    def remainder_nnz_fraction(self) -> float:
        if self.remainder is None:
            return 0.0
        rem = float(torch.count_nonzero(self.remainder.values))
        core = float(torch.count_nonzero(self.core.band))
        return rem / max(rem + core, 1.0)


def split_spmm(A: SplitBanded, U: torch.Tensor) -> torch.Tensor:
    """A @ U: the core through K4, plus the remainder's gather SpMM."""
    from eigenpinns_torch.sparse.ops import spmm

    out = banded_spmm(A.core, U)
    if A.remainder is not None:
        out = out + spmm(A.remainder, U)
    return out


def split_spmm_gram(A: SplitBanded, U: torch.Tensor):
    """(A @ U, U^T A U): the fused Gram of the core (K5), plus the thin
    remainder correction U^T (A_rem U)."""
    from eigenpinns_torch.sparse.ops import gram, spmm

    W, G = banded_spmm_gram(A.core, U)
    if A.remainder is not None:
        Wr = spmm(A.remainder, U)
        W = W + Wr
        G = G + gram(U, Wr)
    return W, G
