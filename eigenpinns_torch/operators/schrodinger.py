"""1D/ND Schrodinger operators with autodiff Hessian-trace residuals.

Port of `eigenpinns_tpu/operators/schrodinger.py` (the quantumNN line of
the reference, README.md:9-22): eigenpairs of H = -1/2 Lap + V learned
from collocation batches. The JAX package takes second derivatives by
forward-over-forward `jax.jvp` per point under `vmap`; here they are
reverse-over-reverse `torch.autograd.grad(..., create_graph=True)` on the
whole batch. That is exact because every `u_fn` of the package maps each
point on its own (an MLP and a pointwise window), so the gradient of
sum_i u(x_i) with respect to x_i is u's gradient at x_i. The results keep
their graph, so a loss built on them backpropagates to the parameters.

Known spectra used as test oracles:
  infinite well, width L:    E_n = n^2 pi^2 / (2 L^2),  n = 1, 2, ...
  harmonic oscillator:       E_n = n + 1/2,             n = 0, 1, ...
"""

from __future__ import annotations

import math
from typing import Callable

import torch


# ---- potentials ---------------------------------------------------------

def infinite_well(L: float = 1.0) -> Callable:
    """V = 0 inside (0, L); the ansatz window enforces u(0)=u(L)=0."""
    def V(x):
        return torch.zeros_like(x[..., 0])
    return V


def harmonic_oscillator(omega: float = 1.0) -> Callable:
    def V(x):
        return 0.5 * omega**2 * torch.sum(x * x, dim=-1)
    return V


def well_eigenvalues(n: int, L: float = 1.0) -> torch.Tensor:
    k = torch.arange(1, n + 1, dtype=torch.float32)
    return (k * math.pi / L) ** 2 / 2.0


def oscillator_eigenvalues(n: int, omega: float = 1.0) -> torch.Tensor:
    return omega * (torch.arange(n, dtype=torch.float32) + 0.5)


# ---- derivatives by reverse-over-reverse autograd ------------------------

def _with_grad(u_fn: Callable, x: torch.Tensor):
    """(x as a leaf that requires grad, u_fn(x), grad u (N, d)); the
    gradient keeps its graph."""
    x = x.detach().requires_grad_(True)
    u = u_fn(x)
    (g,) = torch.autograd.grad(u.sum(), x, create_graph=True)
    return x, u, g


def _directional_second(x: torch.Tensor, g: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """v^T H v at every point, from the gradient field g = grad u."""
    (hv,) = torch.autograd.grad((g * v).sum(), x, create_graph=True)
    return (hv * v).sum(dim=1)


def _u_and_laplacian(u_fn: Callable, x: torch.Tensor):
    """(u, trace of the Hessian of u) at (N, d) points from one forward
    pass: d second derivatives along the axes."""
    with torch.enable_grad():
        x, u, g = _with_grad(u_fn, x)
        lap = 0.0
        for i in range(x.shape[1]):
            (hi,) = torch.autograd.grad(g[:, i].sum(), x, create_graph=True)
            lap = lap + hi[:, i]
    return u, lap


def second_derivative_1d(u_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """u''(x) for scalar u over (N, 1) collocation points (the first
    coordinate of x, as the JAX function reads it)."""
    return _u_and_laplacian(u_fn, x[:, 0:1])[1]


def laplacian_nd(u_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """Trace of the Hessian of scalar u over (N, d) points: d second
    derivatives along the axes (exact; d is small for these problems).
    For high d, `hutchinson_laplacian` has the same interface."""
    return _u_and_laplacian(u_fn, x)[1]


def hutchinson_laplacian(u_fn: Callable, x: torch.Tensor,
                         generator: torch.Generator | None = None,
                         n_probes: int = 8,
                         probes: torch.Tensor | None = None) -> torch.Tensor:
    """Stochastic Hessian-trace estimate via Rademacher probes.

    E_v[v^T H v] = tr(H): each probe costs one second derivative like a
    single exact direction, so for d >> n_probes this replaces
    `laplacian_nd`'s d passes. Unbiased; variance ~ 2||H||_F^2 /
    n_probes. The probes (n_probes, d) are drawn from `generator`, or
    given as `probes` (a test feeds the JAX package's).
    """
    d = x.shape[1]
    if probes is None:
        probes = torch.randint(0, 2, (n_probes, d), generator=generator,
                               device=x.device).to(x.dtype) * 2 - 1
    probes = probes.to(device=x.device, dtype=x.dtype)
    with torch.enable_grad():
        x, _, g = _with_grad(u_fn, x)
        est = [_directional_second(x, g, v[None]) for v in probes]
    return torch.stack(est).mean(dim=0)


def schrodinger_residual(u_fn: Callable, V: Callable, lam,
                         x: torch.Tensor) -> torch.Tensor:
    """r(x) = -1/2 Lap u + V u - lam u at each collocation point (u and
    its Laplacian from one forward pass; in 1D the Laplacian is u'')."""
    u, lap = _u_and_laplacian(u_fn, x)
    return -0.5 * lap + V(x) * u - lam * u


def mc_norm_sq(u: torch.Tensor, volume: float) -> torch.Tensor:
    """Monte-Carlo estimate of int u^2 dx over a domain of given volume."""
    return volume * torch.mean(u * u)


def mc_inner(u: torch.Tensor, v: torch.Tensor, volume: float) -> torch.Tensor:
    return volume * torch.mean(u * v)
