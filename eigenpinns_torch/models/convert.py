"""Carry a flax parameter tree into the torch correctors and eigen-nets.

The tree is the one `model.init` returns in the JAX package, with its
leaves as numpy arrays: {'params': {'MLP_0': {'hidden_0': {'kernel',
'bias'}, ..., 'out': {...}}}} for the simple and spectral correctors
and for `JointEigenNet`, and {'params': {'SimpleCorrector_0': {...},
'mode_scales': ...}} for the adaptive corrector. A flax `Dense` kernel
is (in, out); a torch `Linear.weight` is (out, in).
"""

from __future__ import annotations

import numpy as np
import torch

from eigenpinns_torch.models.correctors import AdaptiveCorrector
from eigenpinns_torch.models.mlp import MLP


def _copy(param: torch.Tensor, value) -> None:
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape mismatch: flax {tuple(value.shape)} vs "
                         f"torch {tuple(param.shape)}")
    param.copy_(value)


def _load_mlp(mlp: MLP, tree) -> None:
    layers = [*mlp.hidden, mlp.out]
    names = [f"hidden_{i}" for i in range(len(mlp.hidden))] + ["out"]
    if set(tree) != set(names):
        raise ValueError(f"flax MLP has {sorted(tree)}, expected {names}")
    for layer, name in zip(layers, names):
        _copy(layer.weight, np.asarray(tree[name]["kernel"]).T)
        _copy(layer.bias, tree[name]["bias"])


@torch.no_grad()
def from_flax_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Load `tree` into `module` in place; returns the module."""
    if "params" in tree:
        tree = tree["params"]
    if isinstance(module, AdaptiveCorrector):
        _copy(module.mode_scales, tree["mode_scales"])
        _load_mlp(module.inner.mlp, tree["SimpleCorrector_0"]["MLP_0"])
    elif isinstance(module, MLP):
        _load_mlp(module, tree)
    else:
        _load_mlp(module.mlp, tree["MLP_0"])
    return module
