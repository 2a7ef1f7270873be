"""Large-scale spectral basis driver: N-point cloud -> k eigenpairs.

Port of `eigenpinns_tpu/solvers/spectral_basis.py`:

  1. the point-cloud Laplacian (the port's host stage: its C++ kernels
     when their library loads, else numpy),
  2. a coarse voxel subset -> host eigsh warm start -> kNN prolongation,
  3. a tiled device operator: strip-BSR (`sparse/bsr.py`, kernel K2) or
     the cluster-ordered SplitBanded (`sparse/split.py`, kernel K4),
  4. blocked deflated LOBPCG (`solvers/lobpcg.py::lobpcg_blocked`).

With `n_devices` or `mesh` steps 3-4 run node-sharded on every rank of
an initialized `torch.distributed` group (`solvers/lobpcg_sharded.py`:
the halo-banded sharded SpMM through K4, psum'd reductions); steps 1-2
run on every rank's host alike.

`spectral_basis_family` pads every member of a family of clouds to one
common strip-BSR shape without group tables, so its solves run kernel K3.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import scipy.sparse as sp
import torch

from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.sampling.knn import prolongation_matrix
from eigenpinns_torch.sampling.samplers import voxel_levels
from eigenpinns_torch.solvers.lobpcg import lobpcg_blocked
from eigenpinns_torch.solvers.oracle import eigsh_smallest
from eigenpinns_torch.sparse.banded import _round_up
from eigenpinns_torch.sparse.bsr import BSRTile
from eigenpinns_torch.sparse.formats import Diagonal
from eigenpinns_torch.sparse.split import SplitBanded
from eigenpinns_torch.utils.profiling import span

OPERATOR_FORMATS = ("bsr", "split")


@dataclasses.dataclass
class SpectralBasisResult:
    eigenvalues: np.ndarray     # (k,)
    eigenvectors: np.ndarray    # (n, k) in ORIGINAL point order
    residual_norms: np.ndarray  # (k,) scaled |Ku - lam Mu| / max(1, |lam|)
    timings: dict


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _warm_start(X, L, m_diag, k, n_neighbors, coarse_n,
                prolongation_neighbors) -> np.ndarray:
    """(n, k) fp32 warm start: eigsh on a voxel subset, prolongated to the
    full cloud (eigsh on the full operator when the subset is the cloud)."""
    n = X.shape[0]
    coarse_n = min(coarse_n, n)
    if coarse_n < n:
        idx = voxel_levels(X, [coarse_n])[0]
        Xc = X[idx]
        Lc, Mc = point_cloud_laplacian(Xc, n_neighbors=n_neighbors)
        _, vecs_c = eigsh_smallest(Lc, Mc, k)
        P = prolongation_matrix(Xc, X, prolongation_neighbors)
        return (P @ vecs_c).astype(np.float32)
    _, vecs = eigsh_smallest(L, sp.diags(m_diag).tocsr(), k)
    return vecs.astype(np.float32)


def spectral_basis(
    X: np.ndarray,
    k: int = 50,
    n_neighbors: int = 15,
    coarse_n: int = 65536,
    prolongation_neighbors: int = 8,
    window: int = 1024,
    block: int = 16,
    guard: int = 4,
    max_iter: int = 120,
    tol: float = 2e-4,
    operators=None,
    operator_format: str = "bsr",
    operator_precision: str = "highest",
    n_devices: int | None = None,
    mesh=None,
    checkpoint_dir: str = "",
    log_fn=print,
    device="cuda",
) -> SpectralBasisResult:
    """Smallest-k Laplace-Beltrami eigenpairs of an (n, 3) point cloud.

    `operators`: an optional pre-built (L_csr, m_diag) pair that skips
    the Laplacian build. `operator_format`: 'bsr' (strip-BSR, RCM order)
    or 'split' (cluster-ordered banded core of width `window` + gather
    remainder). `operator_precision` ('highest', 'high', 'bf16') applies
    to 'bsr' only, as in the JAX package; 'highest' and 'high' are both
    exact fp32 on the card. The solve runs on `device`, or with
    `n_devices` / `mesh` on the mesh (every rank calls it alike and gets
    the same result; `operator_format` and `device` are then not read:
    the sharded operator picks its own form, on the mesh's device; a
    mesh made here is on `device`'s type).
    """
    sharded = n_devices is not None or mesh is not None
    if sharded:
        from eigenpinns_torch.solvers.direct_sharded import resolve_mesh

        mesh = resolve_mesh(mesh, n_devices, device)
        if operator_precision != "highest":
            import warnings

            warnings.warn(
                "operator_precision is not supported on the sharded path "
                "(its banded blocks run fp32); solving at 'highest'",
                stacklevel=2)
    if operator_format not in OPERATOR_FORMATS:
        raise ValueError(f"operator_format must be one of "
                         f"{OPERATOR_FORMATS}, got {operator_format!r}")
    device = torch.device(device)
    X = np.asarray(X)
    timings = {}
    n = X.shape[0]

    t0 = time.time()
    if operators is not None:
        L, m_diag = operators
    else:
        L, M = point_cloud_laplacian(X, n_neighbors=n_neighbors)
        m_diag = np.asarray(M.diagonal()).ravel()
    timings["laplacian_s"] = time.time() - t0

    t0 = time.time()
    X0_full = _warm_start(X, L, m_diag, k, n_neighbors, coarse_n,
                          prolongation_neighbors)
    timings["warm_start_s"] = time.time() - t0

    if sharded:
        from eigenpinns_torch.solvers.lobpcg_sharded import lobpcg_sharded

        t0 = time.time()
        vals, vecs, resids = lobpcg_sharded(
            L, sp.diags(m_diag).tocsr(), k, mesh=mesh, X=X, X0=X0_full,
            block=block, guard=guard, max_iter=max_iter, tol=tol,
            window=window, checkpoint_dir=checkpoint_dir,
            log_fn=(None if log_fn is None else
                    lambda b0, keep, r: log_fn(
                        f"  modes [{b0}:{b0 + keep}] converged")))
        timings["solve_s"] = time.time() - t0
        return SpectralBasisResult(vals, vecs, resids, timings)

    t0 = time.time()
    if operator_format == "bsr":
        op, perm = BSRTile.from_scipy(L, device=device)
        if operator_precision != "highest":
            op = op.with_precision(operator_precision)
    else:
        op, perm = SplitBanded.from_scipy(L, X=X, window=window,
                                          device=device)
    M_op = Diagonal(torch.as_tensor(m_diag[perm], dtype=torch.float32,
                                    device=device))
    _sync(device)
    timings["operator_s"] = time.time() - t0

    def _log(b0, keep, res):
        if log_fn is not None:
            log_fn(f"  modes [{b0}:{b0 + keep}] converged, max scaled res "
                   f"{float(res.residual_norms[:keep].max()):.2e}")

    t0 = time.time()
    with span("spectral_basis.solve"):
        vals, vecs, resids = lobpcg_blocked(
            op, M_op, k, block=block, guard=guard, max_iter=max_iter,
            tol=tol, X0_full=torch.as_tensor(X0_full[perm], device=device),
            checkpoint_dir=checkpoint_dir, log_fn=_log)
    timings["solve_s"] = time.time() - t0

    inv = np.empty_like(perm)
    inv[perm] = np.arange(n)
    return SpectralBasisResult(vals, vecs[inv], resids, timings)


def family_operators(laplacians, device="cuda") -> list:
    """[(op, perm)] for a family of Laplacians: each member's strip-BSR
    operator padded to the family's common (rows, chunks) shape, without
    group tables (`static_layout=False`: the JAX package's traced layout,
    which compiles one executable for the whole family; here it selects
    kernel K3). The pad rows and pad chunks are zero."""
    n_pad = _round_up(max(L.shape[0] for L in laplacians), 128)
    ops = [BSRTile.from_scipy(L, device=device, pad_rows_to=n_pad,
                              static_layout=False) for L in laplacians]
    n_chunks = max(op.n_chunks for op, _ in ops)
    # Rebuild any member below the common chunk count (its RCM ordering
    # is reused; only zero pad chunks are appended).
    return [(op, perm) if op.n_chunks == n_chunks else
            BSRTile.from_scipy(L, device=device, pad_rows_to=n_pad,
                               pad_chunks_to=n_chunks, perm=perm,
                               static_layout=False)
            for (op, perm), L in zip(ops, laplacians)]


def spectral_basis_family(
    X_list,
    k: int = 50,
    n_neighbors: int = 15,
    coarse_n: int = 65536,
    prolongation_neighbors: int = 8,
    block: int = 16,
    guard: int = 4,
    max_iter: int = 120,
    tol: float = 2e-4,
    log_fn=print,
    device="cuda",
) -> list:
    """`spectral_basis` over a family of point clouds, each on its
    member of `family_operators` (kernel K3). Zero pad rows are inert in
    the solver. Returns a list of SpectralBasisResult in input order."""
    device = torch.device(device)

    # Pass 1 (host): Laplacians, then the family's padded operators.
    probs = []
    for X in X_list:
        X = np.asarray(X)
        L, M = point_cloud_laplacian(X, n_neighbors=n_neighbors)
        probs.append((X, L, np.asarray(M.diagonal()).ravel()))
    ops = family_operators([L for _, L, _ in probs], device=device)

    results = []
    for (op, perm), (X, L, m_diag) in zip(ops, probs):
        n, n_pad = X.shape[0], op.n
        timings = {}
        t0 = time.time()
        X0 = _warm_start(X, L, m_diag, k, n_neighbors, coarse_n,
                         prolongation_neighbors)
        timings["warm_start_s"] = time.time() - t0

        d = np.zeros(n_pad, np.float32)
        d[:n] = m_diag[perm]
        X0p = np.zeros((n_pad, k), np.float32)
        X0p[:n] = X0[perm]          # op row order; padded rows stay zero
        t0 = time.time()
        vals, vecs, resids = lobpcg_blocked(
            op, Diagonal(torch.as_tensor(d, device=device)), k, block=block,
            guard=guard, max_iter=max_iter, tol=tol,
            X0_full=torch.as_tensor(X0p, device=device),
            log_fn=None if log_fn is None else
            (lambda b0, keep, r: log_fn(f"  [{n}v] modes [{b0}:{b0+keep}]")))
        timings["solve_s"] = time.time() - t0
        inv = np.empty_like(perm)
        inv[perm] = np.arange(n)
        results.append(SpectralBasisResult(vals, vecs[:n][inv], resids,
                                           timings))
    return results
