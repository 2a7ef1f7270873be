"""Debug and determinism utilities.

Port of `eigenpinns_tpu/utils/debug.py`: NaN trapping through autograd's
anomaly mode (the JAX package uses jax's debug-nans mode), a
deterministic mode that pins every random number generator, and a host
check that a set of tensors is finite.
"""

from __future__ import annotations

import contextlib
import random

import numpy as np
import torch


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Raise on the first NaN that a backward pass produces
    (`torch.autograd.set_detect_anomaly`, which also names the forward
    operation that created it). Slow: for debugging only."""
    with torch.autograd.set_detect_anomaly(enable):
        yield


def deterministic_mode(seed: int = 0, device="cuda") -> torch.Generator:
    """Pin Python's, numpy's and torch's global generators; returns a
    fresh `torch.Generator` on `device` seeded with `seed` for the run."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return torch.Generator(device).manual_seed(seed)


def assert_finite(tensors, name: str = "tensors") -> None:
    """Host-side finiteness check over a tensor, a state_dict or any
    nesting of dicts, lists and tuples of tensors or arrays (post-step
    validation)."""
    if isinstance(tensors, dict):
        leaves = list(tensors.items())
    elif isinstance(tensors, (list, tuple)):
        leaves = list(enumerate(tensors))
    else:
        leaves = [(None, tensors)]
    for key, leaf in leaves:
        label = name if key is None else f"{name}[{key!r}]"
        if isinstance(leaf, (dict, list, tuple)):
            assert_finite(leaf, label)
            continue
        arr = torch.as_tensor(leaf)
        finite = torch.isfinite(arr)
        if not bool(finite.all()):
            bad = arr.numel() - int(finite.sum())
            raise FloatingPointError(f"{label} has {bad} non-finite values")
