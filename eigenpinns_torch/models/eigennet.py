"""Joint eigenfunction network: one MLP predicts all k eigenfunctions.

Port of `JointEigenNet` from `eigenpinns_tpu/models/eigennet.py`
(scripts/simplified_loss.ipynb cell 0:90-104): MLP(x) -> (N, k) with
flax's default initialization (LeCun-normal kernels, zero biases, a
LeCun-normal head). The flax parameter tree is
{'params': {'MLP_0': {...}}}; `models.convert.from_flax_params` loads it.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from eigenpinns_torch.models.mlp import MLP


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
