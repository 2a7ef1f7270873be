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
Not ported yet (ROADMAP queue 1, item 6): node-minibatched training
(`batch_nodes`); asking for it raises NotImplementedError.
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
from eigenpinns_torch.sparse.ops import rayleigh_quotients
from eigenpinns_torch.train.loop import module_state_fns, run_chunked_loop
from eigenpinns_torch.train.optim import adam_exp_decay


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
) -> DirectResult:
    """Learn all n_modes eigenfunctions of K u = lam M u jointly.

    Runs on `device` (default: the device of K's diagonal). `init_params`
    (a state_dict of `JointEigenNet`, e.g. flax parameters carried in by
    `from_flax_params`) replaces the seeded initialization, which draws
    from `generator` (default: a generator on `device` seeded with
    `seed`).
    """
    if mode not in ("penalty", "whiten"):
        raise ValueError(f"mode must be 'penalty' or 'whiten', got '{mode}'")
    if batch_nodes > 0:
        raise NotImplementedError(
            "batch_nodes is not ported to the torch train_joint yet "
            "(ROADMAP queue 1, item 6)")
    device = torch.device(device) if device is not None else (
        K.diagonal().device)
    X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=device)

    model = JointEigenNet(X.shape[1], tuple(hidden), n_modes,
                          activation=activation,
                          compute_dtype=mlp_compute_dtype).to(device)
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        model.reset_parameters(generator if generator is not None else
                               torch.Generator(device).manual_seed(seed))
    params = list(model.parameters())
    opt, _ = adam_exp_decay(params, lr_start, lr_end, epochs)

    # The loss SpMMs run in loss_mxu_precision; the finish below keeps
    # the original ('highest') operators. 'highest' and 'high' share the
    # fp32 strips.
    K_l = (K.with_precision(loss_mxu_precision)
           if hasattr(K, "with_precision") else K)
    M_l = (M.with_precision(loss_mxu_precision)
           if hasattr(M, "with_precision") else M)

    def loss_fn():
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
        total, metrics = loss_fn()
        total.backward()
        opt.step()
        return metrics

    result = run_chunked_loop(step, n_epochs=epochs, chunk=scan_chunk,
                              log_every=log_every, log_fn=log_fn,
                              device=device, timing_chunks=timing_chunks,
                              state_fns=module_state_fns(params, opt))

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
