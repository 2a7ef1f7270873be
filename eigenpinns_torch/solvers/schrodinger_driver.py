"""Schrodinger eigenpair solver with the parametric boundary ansatz.

Port of `eigenpinns_tpu/solvers/schrodinger_driver.py` (BASELINE.json
config 2): the 1D infinite well and harmonic oscillator, or an ND box,
solved with u(x) = g(x) * NN([x, lambda]) (exact Dirichlet or decay
through the window g), a learnable eigenvalue lambda = |lambda_raw|,
Monte-Carlo normalization over fresh collocation batches each step, and
sequential deflation against the modes already found on a fixed
quadrature set. Residuals are autodiff second derivatives
(`operators/schrodinger.py`), no assembled matrices.

The products run in full fp32: the residual is a second derivative of
the network, and with reduced-precision matmuls lambda stalls short of
the eigenvalue (the JAX package saw well mode 2 at 17.6 against 19.74
and runs the driver under `default_matmul_precision("highest")`). The
driver sets torch's float32 matmul precision to "highest" for its run
and restores it after; TF32 is off for the whole package.

Random draws come from `torch.Generator`s seeded from `seed`, so they
differ from JAX's: the collocation batch of mode m from a generator
seeded with seed + 7 m, its initialization from one seeded with
seed + 31 m. Two seams let a test run the JAX package's exact problem:
`init_params[m]` (a `SchrodingerMode` state_dict, e.g. flax parameters
carried in by `from_flax_params`; lambda_raw always starts at the mode's
warm start, as flax's initializer sets it) and `draws(m, epoch)`, the
(batch_size, d) unit-uniform draw of that step.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch
from torch import nn

from eigenpinns_torch.models.eigennet import abs_jax
from eigenpinns_torch.models.mlp import MLP
from eigenpinns_torch.operators.schrodinger import (
    mc_norm_sq,
    schrodinger_residual,
)
from eigenpinns_torch.train.loop import run_chunked_loop
from eigenpinns_torch.train.optim import Adam


class SchrodingerMode(nn.Module):
    """u(x) = g(x) * NN([x, lambda]) with trainable lambda = |lambda_raw|.

    forward(x (N, d)) -> (u (N,), lam 0-dim). The flax tree is {'params':
    {'lambda_raw': (1,), 'MLP_0': {...}}}."""

    def __init__(self, in_dim: int, hidden: Sequence[int], window: Callable,
                 lambda_init: float = 1.0, activation: str = "tanh"):
        super().__init__()
        self.window = window
        self.lambda_init = float(lambda_init)
        self.lambda_raw = nn.Parameter(torch.full((1,), self.lambda_init))
        self.mlp = MLP(in_dim + 1, tuple(hidden), 1, activation=activation)

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initialization: lambda_raw = lambda_init, LeCun-normal
        kernels, zero biases."""
        with torch.no_grad():
            self.lambda_raw.fill_(self.lambda_init)
        self.mlp.reset_parameters(generator)

    def forward(self, x: torch.Tensor):
        lam = abs_jax(self.lambda_raw)[0]
        n = x.shape[0]
        vals = self.mlp(torch.cat([x, lam.expand(n, 1)], dim=1))
        g = torch.reshape(self.window(x), (n, 1))
        return (g * vals)[:, 0], lam


@dataclasses.dataclass
class SchrodingerResult:
    eigenvalues: np.ndarray
    mode_params: list            # per-mode trained state_dicts
    histories: list
    model: SchrodingerMode       # the shared architecture
    chunk_times: list = dataclasses.field(default_factory=list)
    # [(n_epochs, seconds)] per chunk, one list per mode

    @torch.no_grad()
    def eval_mode(self, i: int, x) -> np.ndarray:
        self.model.load_state_dict(self.mode_params[i])
        dev = self.model.lambda_raw.device
        u, _ = self.model(torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                          device=dev))
        return u.cpu().numpy()


def solve_schrodinger(
    potential: Callable,
    window: Callable,
    domain,                        # (a, b) for 1D, or [(a1,b1), ...] for ND
    n_modes: int,
    hidden=(64, 64),
    epochs_per_mode: int = 3000,
    scan_chunk: int = 250,
    batch_size: int = 256,
    quad_points: int = 512,
    lr: float = 2e-3,
    w_res: float = 1.0,
    w_norm: float = 100.0,
    w_defl: float = 1000.0,
    w_anchor: float = 1.0,
    lambda_init: float = 1.0,
    lambda_growth: float = 1.6,
    seed: int = 0,
    log_fn=None,
    log_every: int = 0,
    device="cuda",
    init_params: list | None = None,
    draws: Callable | None = None,
) -> SchrodingerResult:
    """Find the lowest n_modes eigenpairs of -1/2 Lap u + V u = lam u.

    1D domains get a regular quadrature grid; ND boxes a fixed uniform
    Monte-Carlo quadrature set (numpy, seeded with seed + 999, as in JAX).
    Each mode trains a fresh `SchrodingerMode` warm-started at lambda_0 =
    `lambda_init`, then lambda_prev * `lambda_growth` + 0.5, with
    Adam(lr), and is normalized on the quadrature set and stored for the
    deflation of the next modes. Runs on `device`; one host sync a chunk
    of `scan_chunk` epochs.
    """
    device = torch.device(device)
    dom = np.asarray(domain, dtype=np.float64)
    if dom.ndim == 1:
        dom = dom.reshape(1, 2)
    d = dom.shape[0]
    lo, hi = dom[:, 0], dom[:, 1]
    volume = float(np.prod(hi - lo))
    if d == 1:
        xq = np.linspace(lo[0], hi[0], quad_points).reshape(-1, 1)
    else:
        qr = np.random.default_rng(seed + 999)
        xq = lo + (hi - lo) * qr.uniform(size=(quad_points, d))
    x_quad = torch.as_tensor(xq, dtype=torch.float32, device=device)
    lo_t = torch.as_tensor(lo, dtype=torch.float32, device=device)
    span_t = torch.as_tensor(hi - lo, dtype=torch.float32, device=device)
    V_quad = potential(x_quad)

    mode_params, eigenvalues, histories, chunk_times = [], [], [], []
    prev_quad = torch.zeros((quad_points, 0), device=device)
    lam0 = lambda_init
    prev_precision = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        for m in range(n_modes):
            model = SchrodingerMode(d, tuple(hidden), window,
                                    lambda_init=lam0).to(device)
            if init_params is None:
                model.reset_parameters(
                    torch.Generator(device).manual_seed(seed + 31 * m))
            else:
                model.load_state_dict(init_params[m])
                with torch.no_grad():
                    model.lambda_raw.fill_(model.lambda_init)
            params = list(model.parameters())
            opt = Adam(params, lambda t: lr)
            U_prev = prev_quad if prev_quad.shape[1] > 0 else None
            gen = torch.Generator(device).manual_seed(seed + 7 * m)

            def u_fn(xx, model=model):
                return model(xx)[0]

            def step(epoch: int, m=m, model=model, params=params, opt=opt,
                     U_prev=U_prev, gen=gen, u_fn=u_fn):
                if draws is None:
                    unit = torch.rand((batch_size, d), generator=gen,
                                      device=device)
                else:
                    unit = torch.as_tensor(draws(m, epoch),
                                           dtype=torch.float32,
                                           device=device)
                x = lo_t + span_t * unit
                lam = abs_jax(model.lambda_raw)[0]
                r = schrodinger_residual(u_fn, potential, lam, x)
                loss = w_res * torch.mean(r * r)
                xq_in = x_quad.detach().requires_grad_(w_anchor > 0)
                u_q = u_fn(xq_in)
                norm = (mc_norm_sq(u_q, volume) - 1.0) ** 2
                loss = loss + w_norm * norm
                if U_prev is not None:
                    # mc_inner of u_q with each found mode.
                    inner = volume * torch.mean(u_q[:, None] * U_prev, dim=0)
                    loss = loss + w_defl * torch.sum(inner**2)
                if w_anchor > 0:
                    # Anchor lambda to the Rayleigh quotient of the current
                    # function, lam_R = <1/2 |grad u|^2 + V u^2> / <u^2>,
                    # held constant (JAX's stop_gradient): without it lambda
                    # can park at its warm start while the residual finds a
                    # nearby stationary point.
                    (gq,) = torch.autograd.grad(u_q.sum(), xq_in,
                                                retain_graph=True)
                    uq = u_q.detach()
                    num = (0.5 * torch.mean(torch.sum(gq * gq, dim=1))
                           + torch.mean(V_quad * uq * uq))
                    lam_R = num / (torch.mean(uq * uq) + 1e-12)
                    loss = loss + w_anchor * (lam - lam_R) ** 2
                for p in params:
                    p.grad = None
                loss.backward()
                opt.step()
                return {"loss": loss.detach(), "lam": lam.detach(),
                        "norm": norm.detach()}

            result = run_chunked_loop(step, n_epochs=epochs_per_mode,
                                      chunk=scan_chunk, log_every=log_every,
                                      log_fn=log_fn, device=device)
            with torch.no_grad():
                u_q, lam = model(x_quad)
                # Normalize on the quadrature set and store for deflation.
                scale = torch.sqrt(mc_norm_sq(u_q, volume) + 1e-12)
                prev_quad = torch.cat([prev_quad, (u_q / scale)[:, None]],
                                      dim=1)
            mode_params.append({k: v.detach().clone()
                                for k, v in model.state_dict().items()})
            eigenvalues.append(float(lam))
            histories.append(result.history)
            chunk_times.append(result.chunk_times)
            lam0 = float(lam) * lambda_growth + 0.5
    finally:
        torch.set_float32_matmul_precision(prev_precision)

    return SchrodingerResult(
        eigenvalues=np.asarray(eigenvalues),
        mode_params=mode_params,
        histories=histories,
        model=SchrodingerMode(d, tuple(hidden), window).to(device),
        chunk_times=chunk_times,
    )
