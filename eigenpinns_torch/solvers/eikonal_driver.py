"""Delta-PINN eikonal solver: geodesic distance from spectral encodings.

Port of `eigenpinns_tpu/solvers/eikonal_driver.py` (the Laplace-PINN-coil
application, Laplace-PINN-coil.ipynb cells 1-36): an MLP maps each
vertex's Laplace-Beltrami eigenfunction coordinates (the Delta-PINN
positional encoding) to a scalar field u solving the surface eikonal
equation |grad_S u| = 1, supervised by a handful of known geodesic
distances:

    loss = w_u MSE(u(x_d), y_d)                     [n_data fixed vertices]
         + w_r MSE(sqrt(u_e^T Bs_e u_e) - 1, 0)     [random element batches]

Ground truth comes from `geometry/geodesics.py` (heat method). The
element batches are drawn on the device, with replacement, from a
`torch.Generator` seeded with seed + 1 (JAX folds the epoch into
PRNGKey(seed + 1)), the initialization from one seeded with `seed`. Two
seams let a test run the JAX package's exact problem: `init_params` (an
`MLP` state_dict, e.g. flax parameters carried in by `from_flax_params`)
and `draws(epoch)` -> (element indices, NTK element indices or None).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch.func import functional_call, grad, vmap

from eigenpinns_torch.models.mlp import MLP
from eigenpinns_torch.operators.eikonal import (
    eikonal_residual,
    gradient_norm_operator,
)
from eigenpinns_torch.train.loop import run_chunked_loop
from eigenpinns_torch.train.optim import Adam, exponential_decay


@dataclasses.dataclass
class EikonalResult:
    u: np.ndarray                # predicted distance field at all vertices
    history: dict
    data_mse: float
    residual_rms: float
    chunk_times: list = dataclasses.field(default_factory=list)
    # [(n_epochs, seconds)] per chunk


def _sq_sum(grads: dict) -> torch.Tensor:
    return sum(torch.sum(g * g) for g in grads.values())


def ntk_traces(model: MLP, enc: torch.Tensor, data_idx: torch.Tensor,
               faces: torch.Tensor, Bs: torch.Tensor, y_sigma: float,
               e_idx: torch.Tensor):
    """Diagonal NTK traces (tr K_uu, tr K_rr) of the two loss terms, in
    the mean convention: both losses are means over their batches, so
    each trace is the batch mean of the squared per-example parameter
    gradients (`torch.func.vmap` over `torch.func.grad`). `e_idx` are the
    elements that estimate the residual term's trace."""
    params = {k: v.detach() for k, v in model.named_parameters()}

    def u_i(p, x):
        return functional_call(model, p, (x[None],))[0, 0]

    def r_e(p, enc_f, B):
        # Bs annihilates constants (a surface-gradient quadratic form), so
        # the y_mu shift drops out.
        u_e = functional_call(model, p, (enc_f,))[:, 0] * y_sigma
        quad = torch.einsum("ij,i,j->", B, u_e, u_e)
        return torch.sqrt(torch.clamp(quad, min=1e-12)) - 1.0

    g_u = vmap(grad(u_i), in_dims=(None, 0))(params, enc[data_idx])
    tr_u = _sq_sum(g_u) / data_idx.shape[0]
    g_r = vmap(grad(r_e), in_dims=(None, 0, 0))(
        params, enc[faces[e_idx]], Bs[e_idx])
    # ntk_batch is a cost knob: in the mean convention the element_batch
    # factor cancels, so fewer elements add variance, never bias.
    tr_r = _sq_sum(g_r) / e_idx.shape[0]
    return tr_u, tr_r


def solve_eikonal(
    mesh,
    encodings: np.ndarray,       # (V, n_eigs) spectral coordinates
    y_data: np.ndarray,          # (V,) ground-truth distances
    n_data: int = 50,
    hidden: Sequence[int] = (100,),
    epochs: int = 20000,
    scan_chunk: int = 500,
    element_batch: int = 512,
    lr: float = 1e-3,
    lr_decay_steps: int = 20000,
    ntk_weights: bool = False,
    ntk_every: int = 1000,
    ntk_batch: int = 128,
    seed: int = 0,
    log_fn=None,
    log_every: int = 0,
    device="cuda",
    init_params: dict | None = None,
    draws: Callable | None = None,
) -> EikonalResult:
    """Train the eikonal PINN; returns the full predicted field.

    The supervised subset is the notebook's fixed random nodes
    (`np.random.default_rng(seed)`, cell 7:88) and the targets are
    scaled by their mean and deviation (cell 7:47). Adam on
    `exponential_decay(lr, lr_decay_steps, 0.1)`.

    ``ntk_weights=True`` enables NTK-based loss balancing (Wang, Yu &
    Perdikaris, "When and why PINNs fail to train: an NTK perspective";
    the reference's driver exposes and disables it at
    Laplace-PINN-coil.ipynb cell 23): at every epoch divisible by
    ``ntk_every`` (epoch 0 included) the step estimates the two traces
    (`ntk_traces`, over the supervised nodes and ``ntk_batch`` random
    elements) and reweights w_k = (tr K_uu + tr K_rr) / tr K_k. The
    weights stay 0-dim device tensors, so the update needs no host sync.
    """
    device = torch.device(device)
    enc = torch.as_tensor(np.asarray(encodings), dtype=torch.float32,
                          device=device)
    faces = torch.as_tensor(np.asarray(mesh.faces, np.int64), device=device)
    Bs = torch.as_tensor(gradient_norm_operator(mesh.verts, mesh.faces),
                         dtype=torch.float32, device=device)
    n_faces = faces.shape[0]
    n_verts = enc.shape[0]

    rng = np.random.default_rng(seed)
    data_idx = torch.as_tensor(
        rng.choice(n_verts, size=min(n_data, n_verts), replace=False),
        device=device)
    y_mu, y_sigma = float(np.mean(y_data)), float(np.std(y_data) + 1e-12)
    y = torch.as_tensor((y_data - y_mu) / y_sigma, dtype=torch.float32,
                        device=device)
    y_d = y[data_idx]

    model = MLP(enc.shape[1], tuple(hidden), 1, activation="tanh").to(device)
    if init_params is None:
        model.reset_parameters(torch.Generator(device).manual_seed(seed))
    else:
        model.load_state_dict(init_params)
    params = list(model.parameters())
    opt = Adam(params, exponential_decay(lr, lr_decay_steps, 0.1))
    gen = torch.Generator(device).manual_seed(seed + 1)
    one = torch.ones((), device=device)
    weights = {"w_u": one, "w_r": one}

    def step(epoch: int):
        ntk_now = ntk_weights and epoch % ntk_every == 0
        if draws is None:
            e_idx = torch.randint(0, n_faces, (element_batch,),
                                  generator=gen, device=device)
            ntk_idx = (torch.randint(0, n_faces, (ntk_batch,), generator=gen,
                                     device=device) if ntk_now else None)
        else:
            e_idx, ntk_idx = draws(epoch)
            e_idx = torch.as_tensor(e_idx, device=device).long()
            if ntk_now:
                ntk_idx = torch.as_tensor(ntk_idx, device=device).long()
        if ntk_now:
            tr_u, tr_r = ntk_traces(model, enc, data_idx, faces, Bs, y_sigma,
                                    ntk_idx)
            tot = tr_u + tr_r
            weights["w_u"] = tot / (tr_u + 1e-12)
            weights["w_r"] = tot / (tr_r + 1e-12)
        w_u, w_r = weights["w_u"], weights["w_r"]
        u = model(enc)[:, 0]
        loss_u = torch.mean((u[data_idx] - y_d) ** 2)
        # The residual acts on the physical field u * sigma + mu
        # (cell 7:47-53).
        r = eikonal_residual(u * y_sigma + y_mu, Bs[e_idx], faces[e_idx])
        loss_r = torch.mean(r**2)
        total = w_u * loss_u + w_r * loss_r
        for p in params:
            p.grad = None
        total.backward()
        opt.step()
        return {"loss": total.detach(), "data": loss_u.detach(),
                "res": loss_r.detach(), "w_u": w_u, "w_r": w_r}

    result = run_chunked_loop(step, n_epochs=epochs, chunk=scan_chunk,
                              log_every=log_every, log_fn=log_fn,
                              device=device)

    with torch.no_grad():
        u = model(enc)[:, 0].cpu().numpy() * y_sigma + y_mu
        r = eikonal_residual(torch.as_tensor(u, device=device), Bs,
                             faces).cpu().numpy()
    return EikonalResult(
        u=u,
        history=result.history,
        data_mse=float(np.mean((u - y_data) ** 2)),
        residual_rms=float(np.sqrt(np.mean(r**2))),
        chunk_times=result.chunk_times,
    )
