"""Carry a flax parameter tree into the torch correctors and eigen-nets.

The tree is the one `model.init` returns in the JAX package, with its
leaves as numpy arrays:

  * {'params': {'MLP_0': {'hidden_0': {'kernel', 'bias'}, ..., 'out':
    {...}}}} for the simple and spectral correctors and `JointEigenNet`;
  * {'params': {'SimpleCorrector_0': {...}, 'mode_scales': ...}} for the
    adaptive corrector;
  * {'params': {'lambda_raw': (1,), 'hidden_i': {...}, 'out': {...}}}
    for `LambdaEigenNet`;
  * {'params': {'MLP_0': {...}, 'lam': ()}} for `HierarchicalUpscaler`;
  * {'params': {'lambda_raw': (1,), 'MLP_0': {...}}} for
    `SchrodingerMode` (`solvers/schrodinger_driver.py`) and {'params':
    {'MLP_0': {...}}} for `ParametricAnsatz`;
  * the tree of `jax.vmap(JointEigenNet.init)` for
    `StackedJointEigenNet`: the same names, every leaf with a leading
    axis of F members.

A flax `Dense` kernel is (in, out); a torch `Linear.weight` is (out,
in). The stacked kernels keep flax's (F, in, out) layout.
"""

from __future__ import annotations

import numpy as np
import torch

from eigenpinns_torch.models.ansatz import ParametricAnsatz
from eigenpinns_torch.models.correctors import AdaptiveCorrector
from eigenpinns_torch.models.eigennet import (
    LambdaEigenNet,
    StackedJointEigenNet,
)
from eigenpinns_torch.models.mlp import MLP
from eigenpinns_torch.models.upscaler import HierarchicalUpscaler


def _copy(param: torch.Tensor, value) -> None:
    value = torch.from_numpy(np.array(value, dtype=np.float32))
    if tuple(value.shape) != tuple(param.shape):
        raise ValueError(f"shape mismatch: flax {tuple(value.shape)} vs "
                         f"torch {tuple(param.shape)}")
    param.copy_(value)


def _load_layers(layers: list, tree, extra=()) -> None:
    names = [f"hidden_{i}" for i in range(len(layers) - 1)] + ["out"]
    if set(tree) != set(names) | set(extra):
        raise ValueError(f"flax tree has {sorted(tree)}, expected "
                         f"{[*names, *extra]}")
    for layer, name in zip(layers, names):
        _copy(layer.weight, np.asarray(tree[name]["kernel"]).T)
        _copy(layer.bias, tree[name]["bias"])


def _load_mlp(mlp: MLP, tree) -> None:
    _load_layers([*mlp.hidden, mlp.out], tree)


def _load_stacked(net: StackedJointEigenNet, tree) -> None:
    names = [f"hidden_{i}" for i in range(len(net.kernels) - 1)] + ["out"]
    if set(tree) != set(names):
        raise ValueError(f"flax tree has {sorted(tree)}, expected {names}")
    for w, b, name in zip(net.kernels, net.biases, names):
        _copy(w, tree[name]["kernel"])
        _copy(b, tree[name]["bias"])


@torch.no_grad()
def from_flax_params(module: torch.nn.Module, tree) -> torch.nn.Module:
    """Load `tree` into `module` in place; returns the module."""
    # The driver module imports this package; import it at call time.
    from eigenpinns_torch.solvers.schrodinger_driver import SchrodingerMode

    if "params" in tree:
        tree = tree["params"]
    if isinstance(module, SchrodingerMode):
        _copy(module.lambda_raw, tree["lambda_raw"])
        _load_mlp(module.mlp, tree["MLP_0"])
    elif isinstance(module, ParametricAnsatz):
        _load_mlp(module.mlp, tree["MLP_0"])
    elif isinstance(module, AdaptiveCorrector):
        _copy(module.mode_scales, tree["mode_scales"])
        _load_mlp(module.inner.mlp, tree["SimpleCorrector_0"]["MLP_0"])
    elif isinstance(module, LambdaEigenNet):
        _copy(module.lambda_raw, tree["lambda_raw"])
        _load_layers(module.layers(), tree, extra=("lambda_raw",))
    elif isinstance(module, HierarchicalUpscaler):
        _copy(module.lam, tree["lam"])
        _load_mlp(module.mlp, tree["MLP_0"])
    elif isinstance(module, StackedJointEigenNet):
        _load_stacked(module, tree["MLP_0"])
    elif isinstance(module, MLP):
        _load_mlp(module, tree)
    else:
        _load_mlp(module.mlp, tree["MLP_0"])
    return module
