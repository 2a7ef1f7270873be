"""MLP building block (torch.nn).

Port of `eigenpinns_tpu/models/mlp.py` with every activation of its
`ACTIVATIONS`: ReLU (the correctors), SiLU (the joint eigen-nets), GELU
(flax's `nn.gelu` is the tanh approximation), tanh, and sin with the
SIREN-style `first_layer_omega` scaling on the first layer only.
Initialization follows flax's `Dense` defaults: LeCun-normal hidden
kernels (a truncated normal with variance 1/fan_in), zero biases, and
optionally the reference's N(0, 0.01^2) output head with zero bias
(src/multigrid_model.py:211-214).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch import nn

ACTIVATIONS: dict[str, Callable] = {
    "relu": torch.relu,
    "silu": nn.functional.silu,
    "gelu": lambda x: nn.functional.gelu(x, approximate="tanh"),
    "tanh": torch.tanh,
    "sin": torch.sin,
}

_TRUNC_STD = 0.87962566103423978  # std of a unit normal truncated to [-2, 2]


def lecun_normal_(weight: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax `lecun_normal` for a torch (out, in) weight: truncated normal
    on [-2, 2] rescaled to variance 1/fan_in."""
    std = (1.0 / weight.shape[1]) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0,
                              generator=generator)
        weight.mul_(std)
    return weight


class MLP(nn.Module):
    """Hidden layers with `activation` + linear head. Parameters stay
    float32; `compute_dtype` (e.g. 'bfloat16') casts the matmuls and
    activations, and the output is cast back to the input's dtype."""

    def __init__(self, in_dim: int, hidden: Sequence[int], out_dim: int,
                 dropout: float = 0.0, small_output_init: bool = False,
                 compute_dtype: str | None = None, activation: str = "relu",
                 first_layer_omega: float = 1.0):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"activation must be one of {list(ACTIVATIONS)}")
        self.act = ACTIVATIONS[activation]
        self.omega = first_layer_omega if activation == "sin" else 1.0
        self.dropout = dropout
        self.compute_dtype = (getattr(torch, compute_dtype) if compute_dtype
                              else None)
        dims = [in_dim, *hidden]
        self.hidden = nn.ModuleList(
            nn.Linear(a, b) for a, b in zip(dims[:-1], dims[1:]))
        self.out = nn.Linear(dims[-1], out_dim)
        self.small_output_init = small_output_init

    def reset_parameters(self, generator: torch.Generator | None = None):
        with torch.no_grad():
            for layer in self.hidden:
                lecun_normal_(layer.weight, generator)
                layer.bias.zero_()
            if self.small_output_init:
                self.out.weight.normal_(0.0, 0.01, generator=generator)
            else:
                lecun_normal_(self.out.weight, generator)
            self.out.bias.zero_()

    def forward(self, x: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        """`deterministic=False` turns dropout on (flax's convention)."""
        in_dtype = x.dtype
        dt = self.compute_dtype
        if dt is not None:
            x = x.to(dt)
        for i, layer in enumerate(self.hidden):
            w, b = layer.weight, layer.bias
            if dt is not None:
                w, b = w.to(dt), b.to(dt)
            x = nn.functional.linear(x, w, b)
            x = self.act(self.omega * x if i == 0 and self.omega != 1.0 else x)
            if self.dropout > 0.0 and not deterministic:
                x = nn.functional.dropout(x, self.dropout)
        w, b = self.out.weight, self.out.bias
        if dt is not None:
            w, b = w.to(dt), b.to(dt)
        return nn.functional.linear(x, w, b).to(in_dtype)
