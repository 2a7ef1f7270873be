"""Matrix-only hierarchical eigensolver with neural upscalers.

Port of `eigenpinns_tpu/solvers/upscale.py` (`hierarchical_eigensolve`,
downsampling_toy_example.ipynb cell 0:223-250): works on a (K, M) matrix
pair without geometry, refining the coarse eigenvectors level by level
with one `HierarchicalUpscaler` per eigenpair and level (trainable
lambda); the loss is the residual + a decaying normalization weight +
deflation against the pairs already refined on the level (+ optional 1D
smoothness), and each level ends with a Rayleigh-quotient + modified
Gram-Schmidt refinement (`_refine`, cell 0:78-97).

As in the JAX package, the coarse operators are GALERKIN products
K_c = P^T K P (P the index-position linear interpolation), not the
reference's raw subsampling K[ix, ix], which destroys banded
connectivity; the coarsest level is solved exactly by the port's
`eigsh_smallest`. The level operators are `as_operator` ELL matrices
(plain gathers in both packages).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp
import torch

from eigenpinns_torch.models.upscaler import HierarchicalUpscaler
from eigenpinns_torch.solvers.oracle import eigsh_smallest
from eigenpinns_torch.sparse.formats import as_operator
from eigenpinns_torch.sparse.ops import spmm, spmv
from eigenpinns_torch.train.loop import run_chunked_loop
from eigenpinns_torch.train.optim import Adam
from eigenpinns_torch.utils.fixtures import subsample_hierarchy


@dataclasses.dataclass
class UpscaleResult:
    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    level_sizes: list
    chunk_times: list = dataclasses.field(default_factory=list)
    # one [(n_epochs, seconds)] list per (level, pair) training


def _refine(U: torch.Tensor, lam: torch.Tensor, K, M):
    """Per-vector refinement (cell 0:78-97): modified Gram-Schmidt in M,
    M-normalization, then the Rayleigh quotients."""
    cols = []
    for i in range(U.shape[1]):
        v = U[:, i]
        for u_prev in cols:
            v = v - (v @ spmv(M, u_prev)) * u_prev
        v = v / torch.sqrt(v @ spmv(M, v) + 1e-12)
        cols.append(v)
    U = torch.stack(cols, dim=1)
    Ku, Mu = spmm(K, U), spmm(M, U)
    return U, (U * Ku).sum(0) / ((U * Mu).sum(0) + 1e-12)


def _interp_matrix(pos_c: np.ndarray, pos_f: np.ndarray) -> sp.csr_matrix:
    """(n_f, n_c) linear-interpolation prolongation over positions."""
    j = np.searchsorted(pos_c, pos_f, side="right") - 1
    j = np.clip(j, 0, len(pos_c) - 2)
    t = (pos_f - pos_c[j]) / np.maximum(pos_c[j + 1] - pos_c[j], 1e-12)
    t = np.clip(t, 0.0, 1.0)
    rows = np.repeat(np.arange(len(pos_f)), 2)
    cols = np.stack([j, j + 1], axis=1).reshape(-1)
    vals = np.stack([1 - t, t], axis=1).reshape(-1)
    return sp.coo_matrix((vals, (rows, cols)),
                         shape=(len(pos_f), len(pos_c))).tocsr()


def hierarchical_eigensolve(
    K,
    M,
    n_pairs: int,
    levels: list[int],
    sampling: str = "uniform",
    hidden=(64, 64),
    epochs_per_level: int = 1500,
    scan_chunk: int = 250,
    lr: float = 2e-3,
    w_res: float = 1.0,
    w_norm0: float = 10.0,
    norm_decay: float = 100.0,
    norm_floor: float = 0.05,
    w_defl: float = 10.0,
    w_smooth: float = 0.0,
    seed: int = 0,
    device="cuda",
    init_params: list | None = None,
) -> UpscaleResult:
    """Solve the smallest n_pairs of K u = lam M u through a subsampled
    matrix hierarchy with neural coarse -> fine upscaling.

    One upscaler is trained per (level, pair) for `epochs_per_level`
    epochs with Adam(lr); the normalization weight at epoch e is
    w_norm0 (norm_floor + (1 - norm_floor) exp(-e / norm_decay)), in
    fp32 as the JAX loss computes it. `init_params` (a list of upscaler
    state_dicts in training order, level-major) replaces the seeded
    initializations of the MLPs; `lam` always starts at the pair's
    coarse eigenvalue.
    """
    device = torch.device(device)
    K = K.tocsr() if sp.issparse(K) else sp.csr_matrix(K)
    M = M.tocsr() if sp.issparse(M) else sp.csr_matrix(M)
    idx_levels = subsample_hierarchy(K.shape[0], levels, method=sampling,
                                     K=K, seed=seed)

    # Galerkin coarse operators from the finest down.
    K_levels, M_levels, P_list = [K], [M], []
    for level in range(len(idx_levels) - 1, 0, -1):
        P = _interp_matrix(idx_levels[level - 1].astype(np.float64),
                           idx_levels[level].astype(np.float64))
        P_list.insert(0, P)
        K_levels.insert(0, (P.T @ K_levels[0] @ P).tocsr())
        M_levels.insert(0, (P.T @ M_levels[0] @ P).tocsr())

    vals, U = eigsh_smallest(K_levels[0], M_levels[0],
                             min(n_pairs, len(idx_levels[0]) - 2))
    U = torch.as_tensor(U, dtype=torch.float32, device=device)
    lam = torch.as_tensor(vals, dtype=torch.float32, device=device)
    inits = iter(init_params or [])
    chunk_times = []

    for level in range(1, len(idx_levels)):
        n_f = len(idx_levels[level])
        K_l = as_operator(K_levels[level], device=device)
        M_l = as_operator(M_levels[level], device=device)
        P = P_list[level - 1]
        new_cols, new_lams = [], []
        for pair in range(U.shape[1]):
            u_c = U[:, pair]
            base = torch.as_tensor(
                P @ u_c.double().cpu().numpy(), dtype=torch.float32,
                device=device)
            model = HierarchicalUpscaler(
                u_c.shape[0], tuple(hidden), n_f,
                lambda_init=float(lam[pair])).to(device)
            state = next(inits, None)
            if state is not None:
                model.load_state_dict(state)
                with torch.no_grad():
                    model.lam.fill_(model.lambda_init)
            else:
                model.reset_parameters(torch.Generator(device).manual_seed(
                    seed + 101 * level + pair))
            params = list(model.parameters())
            opt = Adam(params, lambda t: lr)
            U_prev = torch.stack(new_cols, dim=1) if new_cols else None

            def step(epoch: int):
                u_f, lam_f = model(u_c, base)
                Mu, Ku = spmv(M_l, u_f), spmv(K_l, u_f)
                loss = w_res * ((Ku - lam_f * Mu) ** 2).mean()
                decay = np.exp(-np.float32(epoch) / np.float32(norm_decay))
                w_norm = np.float32(w_norm0) * (np.float32(norm_floor)
                                                + np.float32(1 - norm_floor)
                                                * decay)
                loss = loss + float(w_norm) * (u_f @ Mu - 1.0) ** 2
                if U_prev is not None:
                    loss = loss + w_defl * ((Mu @ U_prev) ** 2).sum()
                if w_smooth:
                    loss = loss + w_smooth * ((u_f[1:] - u_f[:-1]) ** 2
                                              ).mean()
                for p in params:
                    p.grad = None
                loss.backward()
                opt.step()
                return {"loss": loss.detach(), "lam": lam_f.detach()}

            result = run_chunked_loop(step, n_epochs=epochs_per_level,
                                      chunk=scan_chunk, device=device)
            chunk_times.append(result.chunk_times)
            with torch.no_grad():
                u_f, lam_f = model(u_c, base)
            new_cols.append(u_f)
            new_lams.append(lam_f.detach())
        with torch.no_grad():
            U, lam = _refine(torch.stack(new_cols, dim=1),
                             torch.stack(new_lams), K_l, M_l)

    return UpscaleResult(eigenvalues=lam.cpu().numpy(),
                         eigenvectors=U.cpu().numpy(),
                         level_sizes=[len(i) for i in idx_levels],
                         chunk_times=chunk_times)
