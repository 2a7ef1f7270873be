"""Direct joint eigen-learning: one network predicts all k eigenfunctions.

Port of `eigenpinns_tpu/solvers/direct.py::train_joint`:

  * penalty mode: residual + Gram-penalty orthogonality
    (scripts/simplified_loss.ipynb cell 0);
  * whiten mode: differentiable M-orthonormalization (Newton-Schulz)
    followed by the trace / ordering / diversity / zero-lambda losses
    (scripts/loss_with_rigid_body.ipynb).

Every epoch runs the model on all N points, the loss SpMMs (the operator's
kernel, in `loss_mxu_precision`) and the k x k Grams in fp32, on the
device of the operators; the host syncs once per chunk of `scan_chunk`
epochs (`train/loop.py`; `timing_chunks` runs its throughput probe).
A job's spans: `train.prepare` before the loop (X to the device, the
network, the optimizer, the loss operators' precision), a `train.chunk`
span a chunk, and `train.finish` after it (the Rayleigh-Ritz finish and
the copies to the host).

`batch_nodes > 0` trains node-minibatched (penalty mode only): each step
still runs the model on all N points, but the loss reads a random block
of rows, through the rows' own stencils of a Diagonal or SparseELL
operator, and scales the block's Gram by N / B.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eigenpinns_torch.losses.losses import (
    diversity,
    ordering,
    rayleigh_residual_orth,
    trace_loss,
    zero_lambda,
    zero_mean,
)
from eigenpinns_torch.losses.whitening import newton_schulz_orthonormalize
from eigenpinns_torch.models.eigennet import JointEigenNet
from eigenpinns_torch.solvers.rayleigh_ritz import rayleigh_ritz_robust
from eigenpinns_torch.sparse.formats import Diagonal, SparseELL
from eigenpinns_torch.sparse.ops import hdot, rayleigh_quotients
from eigenpinns_torch.train.loop import module_state_fns, run_chunked_loop
from eigenpinns_torch.train.optim import adam_exp_decay
from eigenpinns_torch.utils.profiling import span


@dataclasses.dataclass
class DirectResult:
    eigenvalues: np.ndarray
    eigenvectors: np.ndarray
    history: dict
    epochs_run: int
    wall_time: float
    chunk_times: list
    steady_steps_per_sec: float | None = None  # timing_chunks probe


def train_joint(
    K,
    M,
    X,
    n_modes: int,
    hidden=(64, 64, 64),
    activation: str = "silu",
    mode: str = "penalty",           # 'penalty' | 'whiten'
    epochs: int = 5000,
    scan_chunk: int = 200,
    lr_start: float = 1e-2,
    lr_end: float = 1e-4,
    w_res: float = 1.0,
    w_orth: float = 1.0,
    w_trace: float = 0.0,
    w_order: float = 0.0,
    w_zero: float = 0.0,
    w_zero_mean: float = 0.0,
    w_diversity: float = 0.0,
    min_gap: float = 0.01,
    ns_iters: int = 6,
    seed: int = 0,
    rayleigh_ritz_finish: bool = True,
    batch_nodes: int = 0,
    loss_mxu_precision: str = "high",
    mlp_compute_dtype: str | None = None,
    log_fn=None,
    log_every: int = 0,
    timing_chunks: int = 0,
    device=None,
    generator: torch.Generator | None = None,
    init_params: dict | None = None,
    batch_rows=None,
) -> DirectResult:
    """Learn all n_modes eigenfunctions of K u = lam M u jointly.

    Runs on `device` (default: the device of K's diagonal). `init_params`
    (a state_dict of `JointEigenNet`, e.g. flax parameters carried in by
    `from_flax_params`) replaces the seeded initialization, which draws
    from `generator` (default: a generator on `device` seeded with
    `seed`).

    `batch_nodes > 0` enables node-minibatched training (the adaptive
    deflation notebook's, iterative_eigenvalues cell 13), penalty mode
    only, on Diagonal or SparseELL operators: each step's residual is
    evaluated exactly on `batch_nodes` random rows (their ELL rows
    reference the full U) and the Gram / Rayleigh denominators on the
    same rows, the Gram scaled by N / B, an unbiased Monte Carlo
    estimate. The rows are drawn uniformly with replacement from a
    generator on `device` seeded with seed + 13; `batch_rows` (an
    (epochs, batch_nodes) integer array) gives them instead, epoch e
    reading row e of it; a shorter array raises ValueError.
    """
    if mode not in ("penalty", "whiten"):
        raise ValueError(f"mode must be 'penalty' or 'whiten', got '{mode}'")
    if batch_nodes and mode == "whiten":
        raise ValueError("batch_nodes requires mode='penalty'")
    if batch_nodes:
        for A in (K, M):
            if not isinstance(A, (Diagonal, SparseELL)):
                raise TypeError(f"minibatching needs Diagonal/SparseELL "
                                f"operators, got {type(A).__name__}")
    with span("train.prepare"):
        device = torch.device(device) if device is not None else (
            K.diagonal().device)
        X = torch.as_tensor(np.asarray(X), dtype=torch.float32,
                            device=device)

        model = JointEigenNet(X.shape[1], tuple(hidden), n_modes,
                              activation=activation,
                              compute_dtype=mlp_compute_dtype).to(device)
        if init_params is not None:
            model.load_state_dict(init_params)
        else:
            model.reset_parameters(
                generator if generator is not None else
                torch.Generator(device).manual_seed(seed))
        params = list(model.parameters())
        opt, _ = adam_exp_decay(params, lr_start, lr_end, epochs)

        # The loss SpMMs run in loss_mxu_precision; the finish below
        # keeps the original ('highest') operators. 'highest' and 'high'
        # share the fp32 strips.
        K_l = (K.with_precision(loss_mxu_precision)
               if hasattr(K, "with_precision") else K)
        M_l = (M.with_precision(loss_mxu_precision)
               if hasattr(M, "with_precision") else M)

        n_nodes = X.shape[0]
        if batch_nodes:
            if batch_rows is not None:
                batch_rows = torch.as_tensor(
                    np.asarray(batch_rows), dtype=torch.int64,
                    device=device)
                if (batch_rows.dim() != 2 or batch_rows.shape[0] < epochs
                        or batch_rows.shape[1] != batch_nodes):
                    raise ValueError(
                        f"batch_rows must hold a row of {batch_nodes} "
                        f"for each of the {epochs} epochs, got "
                        f"{tuple(batch_rows.shape)}")
            else:
                row_gen = torch.Generator(device).manual_seed(seed + 13)
            eye = torch.eye(n_modes, dtype=torch.float32, device=device)

    def minibatch_loss(epoch: int):
        U = model(X)
        if batch_rows is not None:
            rows = batch_rows[epoch]
        else:
            rows = torch.randint(n_nodes, (batch_nodes,), generator=row_gen,
                                 device=device)
        Ku_b = _block_apply(K, rows, U)
        Mu_b = _block_apply(M, rows, U)
        U_b = _take_rows(U, rows)
        lam = (U_b * Ku_b).sum(0) / ((U_b * Mu_b).sum(0) + 1e-12)
        res = ((Ku_b - Mu_b * lam[None, :]) ** 2).mean()
        G = hdot(U_b.T, Mu_b) * (n_nodes / batch_nodes)  # MC Gram estimate
        orth = ((G - eye) ** 2).sum() / n_modes
        total = w_res * res + w_orth * orth
        if w_trace:
            total = total + w_trace * trace_loss(lam)
        return total, {"loss": total, "res": res, "orth": orth,
                       "lam_mean": lam.mean()}

    def loss_fn(epoch: int):
        if batch_nodes:
            return minibatch_loss(epoch)
        U = model(X)
        if mode == "whiten":
            U = newton_schulz_orthonormalize(U, M_l, n_iters=ns_iters)
        lam, res, orth = rayleigh_residual_orth(U, K_l, M_l)
        total = w_res * res + w_orth * orth
        if w_trace:
            total = total + w_trace * trace_loss(lam)
        if w_order:
            total = total + w_order * ordering(lam)
        if w_zero:
            total = total + w_zero * zero_lambda(torch.sort(lam).values)
        if w_zero_mean:
            total = total + w_zero_mean * zero_mean(U, M_l)
        if w_diversity:
            total = total + w_diversity * diversity(torch.sort(lam).values,
                                                    min_gap)
        return total, {"loss": total, "res": res, "orth": orth,
                       "lam_mean": lam.mean()}

    def step(epoch: int):
        for p in params:
            p.grad = None
        total, metrics = loss_fn(epoch)
        total.backward()
        opt.step()
        return metrics

    result = run_chunked_loop(step, n_epochs=epochs, chunk=scan_chunk,
                              log_every=log_every, log_fn=log_fn,
                              device=device, timing_chunks=timing_chunks,
                              state_fns=module_state_fns(params, opt))

    with span("train.finish"):
        with torch.no_grad():
            U = model(X)
            if mode == "whiten":
                U = newton_schulz_orthonormalize(U, M, n_iters=ns_iters)
            if rayleigh_ritz_finish:
                lam, U = rayleigh_ritz_robust(U, K, M)
                lam, U = lam[:n_modes], U[:, :n_modes]
            else:
                lam = rayleigh_quotients(U, K, M)
        return DirectResult(
            eigenvalues=lam.cpu().numpy(),
            eigenvectors=U.cpu().numpy(),
            history=result.history,
            epochs_run=result.epochs_run,
            wall_time=result.wall_time,
            chunk_times=result.chunk_times,
            steady_steps_per_sec=result.steady_rate,
        )


def _take_rows(U: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """U's rows at `idx` (any shape), by `index_select`, whose backward
    pass is an `index_add_`: indexing's sort-based backward took 14.5 ms
    a call at 300k rows, k = 20 and 18750 rows a step on an H100."""
    return U.index_select(0, idx.reshape(-1)).view(*idx.shape, U.shape[1])


def _block_apply(A, rows: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """(A U)[rows] from the rows' own stencils: a Diagonal's entries, or
    a SparseELL's gathered (B, W, k) block summed in fp32."""
    if isinstance(A, Diagonal):
        return A.diag[rows, None] * _take_rows(U, rows)
    if isinstance(A, SparseELL):
        return torch.einsum("bwk,bw->bk",
                            _take_rows(U, A.indices[rows]).float(),
                            A.values[rows].float()).to(U.dtype)
    raise TypeError("minibatching needs Diagonal/SparseELL operators")
