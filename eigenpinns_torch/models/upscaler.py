"""Hierarchical neural upscaler: coarse eigenvector -> fine eigenvector.

Port of `eigenpinns_tpu/models/upscaler.py`
(downsampling_toy_example.ipynb cell 0:104-124): a per-eigenpair tanh MLP
from the coarse eigenvector (n_coarse values) to the fine one (n_fine
values) with a small-init output layer, added to `base` (an
interpolation of the coarse vector), and a trainable eigenvalue `lam`.
The flax tree is {'params': {'MLP_0': {...}, 'lam': ()}}.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from eigenpinns_torch.models.mlp import MLP


class HierarchicalUpscaler(nn.Module):
    """u_fine = base + MLP(u_coarse); lam trainable, init from coarse."""

    def __init__(self, n_coarse: int, hidden: Sequence[int], n_fine: int,
                 lambda_init: float = 0.0):
        super().__init__()
        self.lambda_init = float(lambda_init)
        self.mlp = MLP(n_coarse, tuple(hidden), n_fine, activation="tanh",
                       small_output_init=True)
        self.lam = nn.Parameter(torch.tensor(self.lambda_init))

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.mlp.reset_parameters(generator)
        with torch.no_grad():
            self.lam.fill_(self.lambda_init)

    def forward(self, u_coarse: torch.Tensor,
                base: torch.Tensor | None = None):
        u_fine = self.mlp(u_coarse.reshape(1, -1))[0]
        if base is not None:
            u_fine = base + u_fine
        return u_fine, self.lam
