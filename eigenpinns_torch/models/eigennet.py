"""Eigenfunction networks: joint-k nets and lambda-conditioned nets.

Port of `eigenpinns_tpu/models/eigennet.py`:

  * `JointEigenNet` (scripts/simplified_loss.ipynb cell 0:90-104):
    MLP(x) -> (N, k) with flax's default initialization (LeCun-normal
    kernels, zero biases, a LeCun-normal head). The flax parameter tree
    is {'params': {'MLP_0': {...}}};
  * `StackedJointEigenNet`: F independent `JointEigenNet`s, one per mesh
    of a family, with their kernels stacked (F, in, out) as
    `jax.vmap(JointEigenNet.init)` returns them, applied with one
    `torch.bmm` a layer (the JAX package vmaps `apply` instead);
  * `LambdaEigenNet` (iterative_eigenvalues_on_cloud.ipynb cell 1:20-67):
    one eigenfunction with a learnable eigenvalue lambda = |lambda_raw|
    concatenated onto the input and onto every hidden activation, sin
    activation. Its layers are named `hidden_i` and `out`, as in flax.

`models.convert.from_flax_params` loads each one's flax tree.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from eigenpinns_torch.models.mlp import ACTIVATIONS, MLP, lecun_normal_


def abs_jax(x: torch.Tensor) -> torch.Tensor:
    """|x| with the derivative JAX gives `abs` at 0 (+1, where torch.abs
    gives 0): a learnable eigenvalue |lambda_raw| that starts at
    lambda_raw = 0 must still move (ROADMAP F17)."""
    return torch.where(x >= 0, x, -x)


class JointEigenNet(nn.Module):
    """MLP mapping coordinates (N, in_dim) to k eigenfunction values."""

    def __init__(self, in_dim: int, hidden: Sequence[int], n_modes: int,
                 activation: str = "silu", compute_dtype: str | None = None):
        super().__init__()
        self.mlp = MLP(in_dim, tuple(hidden), n_modes, activation=activation,
                       compute_dtype=compute_dtype)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.mlp.reset_parameters(generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.mlp(x)


class StackedJointEigenNet(nn.Module):
    """F JointEigenNets in one module: X (F, N, in_dim) -> (F, N, k).

    `kernels[i]` is (F, in, out) and `biases[i]` (F, out), the layout of
    the flax tree that `jax.vmap(model.init)` returns; each layer is one
    `torch.bmm` over the F members."""

    def __init__(self, n_members: int, in_dim: int, hidden: Sequence[int],
                 n_modes: int, activation: str = "silu"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {list(ACTIVATIONS)}")
        self.act = ACTIVATIONS[activation]
        dims = [in_dim, *hidden, n_modes]
        self.kernels = nn.ParameterList(
            nn.Parameter(torch.empty(n_members, a, b))
            for a, b in zip(dims[:-1], dims[1:]))
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(n_members, b)) for b in dims[1:])

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's Dense defaults for every member: LeCun-normal kernels
        (fan_in = in), zero biases."""
        with torch.no_grad():
            for w, b in zip(self.kernels, self.biases):
                for f in range(w.shape[0]):
                    w[f].copy_(lecun_normal_(torch.empty_like(w[f].T),
                                             generator).T)
                b.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.kernels) - 1
        for i, (w, b) in enumerate(zip(self.kernels, self.biases)):
            x = torch.bmm(x, w) + b[:, None, :]
            if i < last:
                x = self.act(x)
        return x


class LambdaEigenNet(nn.Module):
    """Single eigenfunction u(x) with a learnable eigenvalue lambda.

    Returns (u: (N, 1), lam: 0-dim). lambda = |lambda_raw| enters every
    layer, so the network represents the parametric family
    f(x, lambda)."""

    def __init__(self, in_dim: int, hidden: Sequence[int],
                 lambda_init: float = 0.1, activation: str = "sin"):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {list(ACTIVATIONS)}")
        self.act = ACTIVATIONS[activation]
        self.lambda_init = float(lambda_init)
        self.n_hidden = len(hidden)
        self.lambda_raw = nn.Parameter(torch.full((1,), self.lambda_init))
        dims = [in_dim, *hidden]
        for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
            self.add_module(f"hidden_{i}", nn.Linear(a + 1, b))
        self.out = nn.Linear(dims[-1] + 1, 1)

    def layers(self) -> list:
        return [getattr(self, f"hidden_{i}") for i in range(self.n_hidden)
                ] + [self.out]

    def reset_parameters(self, generator: torch.Generator | None = None):
        """flax's initialization: lambda_raw = lambda_init, LeCun-normal
        kernels, zero biases."""
        with torch.no_grad():
            self.lambda_raw.fill_(self.lambda_init)
            for layer in self.layers():
                lecun_normal_(layer.weight, generator)
                layer.bias.zero_()

    def forward(self, x: torch.Tensor):
        # Mode 0 of the deflation starts at lambda_raw = 0.
        lam = abs_jax(self.lambda_raw)[0]
        lam_col = lam.expand(x.shape[0], 1)
        h = torch.cat([x, lam_col], dim=1)
        for layer in self.layers()[:-1]:
            h = torch.cat([self.act(layer(h)), lam_col], dim=1)
        return self.out(h), lam
