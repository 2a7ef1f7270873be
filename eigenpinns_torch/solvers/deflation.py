"""Iterative deflation: discover eigenpairs one at a time.

Port of `eigenpinns_tpu/solvers/deflation.py` (the iterative deflation
PINN, iterative_eigenvalues_on_cloud.ipynb cells 1 and 13). A
lambda-conditioned network (`LambdaEigenNet`: the learnable eigenvalue is
concatenated into every layer) minimizes

    ||L u - lam M u||^2  +  w_norm (u^T M u - 1)^2
    + w_defl sum_j (u^T M u_j)^2        [orthogonality to found modes]

per mode (`solve_deflation`), or one network hunts every mode in one
epoch budget and is reinitialized in the loop whenever a mode converges
(`solve_deflation_adaptive`). Both run on the device of K; the SpMMs go
through `sparse.ops.spmm` (the ELL gather for the `as_operator` K of the
examples). Random draws (initialization, collocation noise, minibatch
rows) come from `torch.Generator`s seeded with `seed`, so they differ
from JAX's; `init_params` (one `LambdaEigenNet` state_dict per mode, or
per (re)initialization) replaces the seeded initializations of the
layers, which is how a test carries in the flax parameters. lambda_raw
always starts at its warm start, as flax's initializer sets it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eigenpinns_torch.models.eigennet import LambdaEigenNet
from eigenpinns_torch.solvers.lobpcg import lobpcg
from eigenpinns_torch.sparse.ops import spmv
from eigenpinns_torch.train.loop import run_chunked_loop
from eigenpinns_torch.train.optim import Adam


@dataclasses.dataclass
class DeflationResult:
    eigenvalues: np.ndarray   # (m,)
    eigenvectors: np.ndarray  # (N, m), M-normalized
    histories: list
    epochs_per_mode: list
    chunk_times: list = dataclasses.field(default_factory=list)
    # [(n_epochs, seconds)] per chunk, one list per training run (per
    # mode for `solve_deflation`, one for the adaptive driver)


def _backward(loss: torch.Tensor, params: list) -> None:
    for p in params:
        p.grad = None
    loss.backward()


def _init(model: LambdaEigenNet, state, generator) -> None:
    """The seeded initialization, or the layers of `state` with
    lambda_raw at the model's lambda_init."""
    if state is None:
        model.reset_parameters(generator)
        return
    model.load_state_dict(state)
    with torch.no_grad():
        model.lambda_raw.fill_(model.lambda_init)


def solve_deflation(
    K,
    M,
    X,
    n_modes: int,
    hidden=(64, 64, 64),
    epochs_per_mode: int = 4000,
    scan_chunk: int = 200,
    lr: float = 1e-3,
    w_res: float = 1.0,
    w_norm: float = 10.0,
    w_defl: float = 100.0,
    lambda_delta: float = 0.15,
    rayleigh_lambda: bool = False,
    polish_iters: int = 0,
    perturb_sigma: float = 0.0,
    early_stop_patience: int | None = None,
    ema_decay: float = 0.99,
    ema_slope_tol: float = 1e-7,
    seed: int = 0,
    log_fn=None,
    log_every: int = 0,
    init_params: list | None = None,
) -> DeflationResult:
    """Sequentially find the lowest n_modes eigenpairs of K u = lam M u.

    Per mode: a fresh `LambdaEigenNet` with lambda warm-started at
    lambda_prev + `lambda_delta`, Adam(lr), stopped by the EMA slope of
    the loss (|slope| < ema_slope_tol for `early_stop_patience` epochs,
    cell 1:233-237), then M-normalized and Gram-Schmidt'ed against the
    found modes; `polish_iters` > 0 runs a LOBPCG on [found | u] after
    each mode. Runs on K's device; `init_params[m]`
    replaces mode m's seeded initialization.
    """
    device = K.diagonal().device
    X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=device)
    inf = torch.full((), float("inf"), device=device)

    found_u: list[torch.Tensor] = []
    found_lam: list[float] = []
    histories, epochs_used, chunk_times = [], [], []
    lam_init = 0.0
    for m in range(n_modes):
        model = LambdaEigenNet(
            X.shape[1], tuple(hidden),
            lam_init + (lambda_delta if m > 0 else 0.0)).to(device)
        _init(model, None if init_params is None else init_params[m],
              torch.Generator(device).manual_seed(seed + m))
        params = list(model.parameters())
        opt = Adam(params, lambda t: lr)
        U_prev = torch.stack(found_u, dim=1) if found_u else None
        noise = torch.Generator(device).manual_seed(seed + 17 * m)
        ema = inf

        def step(epoch: int):
            nonlocal ema
            X_in = X
            if perturb_sigma > 0:
                # Point perturbation (the adaptive notebook variant, cell
                # 13): jitter the collocation points each step.
                X_in = X + perturb_sigma * torch.randn(
                    X.shape, generator=noise, device=device)
            u, lam = model(X_in)
            u = u[:, 0]
            Mu = spmv(M, u)
            if rayleigh_lambda:
                Ku = spmv(K, u)
                lam = (u @ Ku) / (u @ Mu + 1e-12)
                res = Ku - lam * Mu
            else:
                res = spmv(K, u) - lam * Mu
            norm = (u @ Mu - 1.0) ** 2
            loss = w_res * (res**2).mean() + w_norm * norm
            if U_prev is not None:
                loss = loss + w_defl * ((Mu @ U_prev) ** 2).sum()
            _backward(loss, params)
            opt.step()
            loss = loss.detach()
            # The EMA is seeded with the first loss, and the slope is inf
            # on that step so that it never reads converged unseeded.
            first = torch.isinf(ema)
            new = torch.where(first, loss,
                              ema_decay * ema + (1 - ema_decay) * loss)
            slope = torch.where(first, inf, ema - new)
            ema = new
            return {"loss": loss, "lam": lam.detach(), "norm": norm.detach(),
                    "ema_slope": slope}

        result = run_chunked_loop(
            step, n_epochs=epochs_per_mode, chunk=scan_chunk,
            early_stop_patience=early_stop_patience,
            early_stop_metric="ema_slope", early_stop_mode="below_tol",
            early_stop_tol=ema_slope_tol, log_every=log_every,
            log_fn=log_fn, device=device)
        histories.append(result.history)
        epochs_used.append(result.epochs_run)
        chunk_times.append(result.chunk_times)

        with torch.no_grad():
            u, lam = model(X)
            u = u[:, 0]
            Mu = spmv(M, u)
            if rayleigh_lambda:
                lam = (u @ spmv(K, u)) / (u @ Mu + 1e-12)
            u = u / torch.sqrt(u @ Mu + 1e-12)
            # Explicit Gram-Schmidt against the found modes.
            for uj in found_u:
                u = u - (u @ spmv(M, uj)) * uj
            u = u / torch.sqrt(u @ spmv(M, u) + 1e-12)
            if polish_iters > 0:
                # A short block LOBPCG from [found | u] snaps the new mode
                # and refreshes the found block.
                X0 = torch.stack([*found_u, u], dim=1)
                res = lobpcg(K, M, X0, k=X0.shape[1], max_iter=polish_iters,
                             tol=1e-7)
                found_u = list(res.eigenvectors.unbind(dim=1))
                found_lam = [float(v) for v in res.eigenvalues.cpu().numpy()]
                lam_init = found_lam[-1]
                histories[-1]["polished_lambda"] = np.asarray(found_lam)
                continue
        found_u.append(u)
        found_lam.append(float(lam))
        lam_init = found_lam[-1]

    U = torch.stack(found_u, dim=1).cpu().numpy()
    return DeflationResult(eigenvalues=np.asarray(found_lam),
                           eigenvectors=U, histories=histories,
                           epochs_per_mode=epochs_used,
                           chunk_times=chunk_times)


def solve_deflation_adaptive(
    K,
    M,
    X,
    n_modes: int,
    hidden=(64, 64, 64),
    epochs: int = 20000,
    scan_chunk: int = 200,
    lr: float = 1e-3,
    w_norm: float = 1.0,
    w_defl: float = 25.0,
    minibatch: int | None = None,
    perturb_factor: float = 0.002,
    trigger: str = "plateau",
    reinit_threshold: float = 1e-7,
    plateau_epochs: int = 500,
    plateau_rtol: float = 1e-3,
    warmup_epochs: int = 2000,
    min_epochs_between: int = 200,
    polish_iters: int = 0,
    seed: int = 0,
    log_fn=None,
    log_every: int = 0,
    init_params: list | None = None,
) -> DeflationResult:
    """Adaptive single-network deflation: minibatched collocation and
    convergence-gated in-loop reinitialization (cell 13:148-271).

    ONE network and ONE epoch budget. Each epoch perturbs the collocation
    points (`perturb_factor` x the domain scale, clamped to the bounding
    box), draws a random row permutation, and takes one Adam step per
    batch of `minibatch` rows with a Rayleigh-quotient lambda, the
    u-normalized residual, the normalization loss and the M-orthogonality
    to every stored mode (inner products over the batch scaled by N/B).
    The trigger (`"plateau"`: the EMA(0.99)-smoothed epoch loss has not
    improved its best by `plateau_rtol` for `plateau_epochs` epochs;
    `"ema_slope"`: the EMA of the epoch-loss slope is under
    `reinit_threshold`) stores the mode, evaluated on the unperturbed
    cloud, and reinitializes the network. The JAX package's deviations
    from the notebook (row-subset minibatches, M-normalized stored modes,
    the `min_epochs_between` cooldown, standard Adam moments) are kept;
    its docstring gives the reasons.

    Deviation: the JAX package decides the store inside the compiled
    scan with `lax.cond`. Here the host reads the trigger once per epoch
    (not per batch step), and only while the epoch, cooldown and count
    gates are open, then stores and reinitializes eagerly. The stop when
    every mode is stored is read once per chunk, as in the JAX loop.
    `init_params[j]` replaces the j-th (re)initialization's parameters.
    """
    if trigger not in ("plateau", "ema_slope"):
        raise ValueError(f"unknown trigger {trigger!r}")
    device = K.diagonal().device
    X = torch.as_tensor(np.asarray(X), dtype=torch.float32, device=device)
    n = X.shape[0]
    B = n if minibatch is None or minibatch > n else int(minibatch)
    num_batches = max(1, n // B)
    scale = n / B
    xmin, xmax = X.min(dim=0).values, X.max(dim=0).values
    domain_scale = (xmax - xmin).mean()
    gen = torch.Generator(device).manual_seed(seed)
    inits = list(init_params or [])
    model = LambdaEigenNet(X.shape[1], tuple(hidden)).to(device)

    def reinit(j: int) -> Adam:
        _init(model, inits[j] if j < len(inits) else None, gen)
        return Adam(list(model.parameters()), lambda t: lr)

    def full(value, dtype=torch.float32):
        return torch.full((), value, dtype=dtype, device=device)

    inf = full(float("inf"))
    st = {"opt": reinit(0), "ema": full(1.0), "prev": inf, "smooth": inf,
          "best": inf, "flat": full(0, torch.int32), "count": 0,
          "last_reinit": 0}
    U_found = torch.zeros((n, n_modes), device=device)
    lam_found = torch.zeros((n_modes,), device=device)
    cols = torch.arange(n_modes, device=device)

    def batch_loss(X_pert, idx, mask):
        u = model(X_pert)[0][:, 0]
        Ku, Mu = spmv(K, u), spmv(M, u)
        ub, Kub, Mub = u[idx], Ku[idx], Mu[idx]
        lam = (ub @ Kub) / (ub @ Mub + 1e-8)
        res = Kub - lam * Mub
        eig_loss = (res**2).mean() / ((ub**2).mean() + 1e-8)
        norm = (scale * (ub @ Mub) - 1.0) ** 2
        over = scale * (Mub @ U_found[idx, :])
        ortho = (torch.where(mask, over, 0.0) ** 2).sum()
        return eig_loss + w_norm * norm + w_defl * ortho, lam

    def epoch_step(epoch: int):
        X_pert = X
        if perturb_factor > 0:
            noise = perturb_factor * domain_scale * torch.randn(
                X.shape, generator=gen, device=device)
            X_pert = torch.clamp(X + noise, xmin, xmax)
        perm = torch.randperm(n, generator=gen, device=device)
        idxs = perm[: num_batches * B].view(num_batches, B)
        mask = cols < st["count"]
        params = list(model.parameters())
        losses, lam = [], None
        for idx in idxs:
            total, lam = batch_loss(X_pert, idx, mask)
            _backward(total, params)
            st["opt"].step()
            losses.append(total.detach())
        avg = torch.stack(losses).mean()
        first = torch.isinf(st["prev"])
        # The reference seeds the slope EMA at 1.0 and updates it once a
        # previous epoch loss exists.
        ema = torch.where(first, full(1.0),
                          0.75 * st["ema"] + 0.25 * (st["prev"] - avg).abs())
        smooth = torch.where(first, avg, 0.99 * st["smooth"] + 0.01 * avg)
        improved = smooth < st["best"] * (1.0 - plateau_rtol)
        best = torch.minimum(st["best"], smooth)
        flat = torch.where(improved, torch.zeros_like(st["flat"]),
                           st["flat"] + 1)
        if trigger == "plateau":
            converged = flat >= plateau_epochs
        else:
            converged = (ema < reinit_threshold) & (ema > 0)
        fire = (epoch >= warmup_epochs
                and epoch - st["last_reinit"] >= min_epochs_between
                and st["count"] < n_modes
                and bool(converged))      # the epoch's one host read
        metrics = {"loss": avg, "ema_slope": ema, "smooth_loss": smooth,
                   "flat": flat.float(), "lam": lam.detach()}
        if fire:
            c = st["count"]
            with torch.no_grad():
                u = model(X)[0][:, 0]
                Ku, Mu = spmv(K, u), spmv(M, u)
                lam_found[c] = (u @ Ku) / (u @ Mu + 1e-8)
                U_found[:, c] = u / torch.sqrt(torch.clamp(u @ Mu,
                                                           min=1e-12))
            st.update(opt=reinit(c + 1), ema=full(1.0), prev=inf,
                      smooth=inf, best=inf, flat=full(0, torch.int32),
                      count=c + 1, last_reinit=epoch)
        else:
            st.update(ema=ema, prev=avg, smooth=smooth, best=best, flat=flat)
        metrics["found"] = full(float(st["count"]))
        metrics["remaining"] = full(float(n_modes - st["count"]))
        return metrics

    result = run_chunked_loop(
        epoch_step, n_epochs=epochs, chunk=scan_chunk,
        early_stop_patience=0, early_stop_metric="remaining",
        early_stop_mode="below_tol", early_stop_tol=0.5,
        log_every=log_every, log_fn=log_fn, device=device)

    count = st["count"]
    U, lam = U_found[:, :count], lam_found[:count]
    # Epoch at which each mode landed, from the count's transitions.
    found_hist = result.history["found"]
    found_at = [int(np.argmax(found_hist >= j + 1)) for j in range(count)]
    if count and polish_iters > 0:
        with torch.no_grad():
            res = lobpcg(K, M, U, k=count, max_iter=polish_iters, tol=1e-7)
        lam, U = res.eigenvalues, res.eigenvectors
    history = dict(result.history)
    history["epochs_run"] = result.epochs_run
    return DeflationResult(eigenvalues=lam.cpu().numpy(),
                           eigenvectors=U.cpu().numpy(),
                           histories=[history], epochs_per_mode=found_at,
                           chunk_times=[result.chunk_times])
