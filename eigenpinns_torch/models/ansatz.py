"""Boundary-enforcing parametric ansatz f(x, lambda) = f_b + g(x) * NN(x, lambda).

Port of `eigenpinns_tpu/models/ansatz.py` (the quantumNN-style
formulation of the reference README, README.md:9-22): the trial function
satisfies Dirichlet boundary conditions exactly by construction -- g(x)
vanishes on the boundary, f_b carries the boundary values -- so no
boundary penalty term is needed. lambda is an input to the network, so
one net represents the whole eigen-family.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

from eigenpinns_torch.models.mlp import MLP


def dirichlet_window(a: float, b: float) -> Callable:
    """g(x) = (x - a)(b - x), zero at both ends of [a, b] (the 1D
    infinite-well Dirichlet trick)."""
    def g(x):
        return (x - a) * (b - x)
    return g


def gaussian_window(scale: float = 1.0) -> Callable:
    """g(x) = exp(-x^2 / (2 scale^2)) -- decaying envelope for problems on
    the whole line (harmonic oscillator)."""
    def g(x):
        return torch.exp(-0.5 * torch.sum(x * x, dim=-1, keepdim=True)
                         / scale**2)
    return g


class ParametricAnsatz(nn.Module):
    """f(x, lambda) = f_b(x) + g(x) * NN([x, lambda]).

    `window` is g(x); `boundary` is f_b(x) (none by default). x: (N, d);
    lam: a scalar or (n_lam,). Output: (N, n_lam), the family at each
    lambda. All lambdas go through ONE batched MLP call (lambda tiled into
    the batch axis), as in the JAX module. The flax tree is {'params':
    {'MLP_0': {...}}}.
    """

    def __init__(self, in_dim: int, hidden: Sequence[int], window: Callable,
                 boundary: Callable | None = None, activation: str = "tanh"):
        super().__init__()
        self.window, self.boundary = window, boundary
        self.mlp = MLP(in_dim + 1, tuple(hidden), 1, activation=activation)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.mlp.reset_parameters(generator)

    def forward(self, x: torch.Tensor, lam) -> torch.Tensor:
        lam = torch.atleast_1d(torch.as_tensor(lam, dtype=x.dtype,
                                               device=x.device))
        n, d = x.shape
        n_lam = lam.shape[0]
        feats = torch.cat([x[None].expand(n_lam, n, d),
                           lam[:, None, None].expand(n_lam, n, 1)], dim=2)
        vals = self.mlp(feats.reshape(n_lam * n, d + 1)).reshape(n_lam, n).T
        out = torch.reshape(self.window(x), (n, 1)) * vals
        if self.boundary is not None:
            out = out + torch.reshape(self.boundary(x), (n, 1))
        return out
