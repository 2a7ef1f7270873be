"""GNN correctors predicting per-node corrections for all k modes.

Port of `eigenpinns_tpu/models/correctors.py` (src/corrector_model.py):

  * SimpleCorrector   — mean over neighbors, MLP(concat(x, agg))
  * SpectralCorrector — one GCN step agg = A_norm @ x, MLP(concat(x, agg))
  * AdaptiveCorrector — SimpleCorrector with learnable per-mode output
                        scales (init 0.01)

The aggregation is a prebuilt operator (`neighbor_mean_operator` /
`gcn_normalized_adjacency`, or a `FunctionOperator` over a sharded SpMM),
whose forward and backward are gathers; `SimpleCorrector` also takes a
(2, E) edge_index, aggregated by the segment sum `neighbor_mean`.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from eigenpinns_torch.models.mlp import MLP
from eigenpinns_torch.sparse.ops import neighbor_mean, spmm


class SimpleCorrector(nn.Module):
    """Neighbor-mean aggregation + MLP."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 dropout: float = 0.0, compute_dtype: str | None = None):
        super().__init__()
        self.mlp = MLP(2 * in_dim, hidden, out_dim, dropout=dropout,
                       small_output_init=True,
                       compute_dtype=compute_dtype)

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.mlp.reset_parameters(generator)

    def forward(self, x, graph, deterministic: bool = True):
        """`graph`: a (2, E) edge_index (tensor or array) or a prebuilt
        mean-aggregation operator."""
        if isinstance(graph, (torch.Tensor, np.ndarray)):
            agg = neighbor_mean(graph, x)
        else:
            agg = spmm(graph, x)
        return self._head(x, agg, deterministic)

    def _head(self, x, agg, deterministic):
        return self.mlp(torch.cat([x, agg], dim=1),
                        deterministic=deterministic)


class SpectralCorrector(SimpleCorrector):
    """One pre-normalized GCN aggregation (A_norm @ x) + MLP; `graph` is
    the `gcn_normalized_adjacency` operator."""

    def forward(self, x, graph, deterministic: bool = True):
        return self._head(x, spmm(graph, x), deterministic)


class AdaptiveCorrector(nn.Module):
    """SimpleCorrector + learnable per-mode output scales."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 dropout: float = 0.0, scale_init: float = 0.01,
                 compute_dtype: str | None = None):
        super().__init__()
        self.scale_init = scale_init
        self.inner = SimpleCorrector(in_dim, hidden, out_dim, dropout,
                                     compute_dtype)
        self.mode_scales = nn.Parameter(torch.full((out_dim,), scale_init))

    def reset_parameters(self, generator: torch.Generator | None = None):
        self.inner.reset_parameters(generator)
        with torch.no_grad():
            self.mode_scales.fill_(self.scale_init)

    def forward(self, x, graph, deterministic: bool = True):
        corr = self.inner(x, graph, deterministic=deterministic)
        return corr * self.mode_scales[None, :]


def make_corrector(model_type: str, in_dim: int, hidden: Sequence[int],
                   out_dim: int, dropout: float = 0.0,
                   compute_dtype: str | None = None) -> nn.Module:
    """The reference's model_type switch (src/multigrid_model.py:203-216
    plus the 'adaptive' notebook variant). `in_dim` is the node feature
    width (flax infers it at init; torch needs it up front)."""
    model_type = model_type.lower()
    classes = {"simple": SimpleCorrector, "spectral": SpectralCorrector,
               "adaptive": AdaptiveCorrector}
    if model_type not in classes:
        raise ValueError(
            f"model_type must be 'simple', 'spectral' or 'adaptive', "
            f"got '{model_type}'")
    return classes[model_type](in_dim, tuple(hidden), out_dim, dropout,
                               compute_dtype=compute_dtype)
