"""Data-parallel training over sharded collocation/node sets.

Port of `eigenpinns_tpu/parallel/data_parallel.py`: model parameters are
replicated, the batch is row-sharded over the mesh's data axis, and a
step equals the single-device step on the whole batch. GSPMD needs no
contract for that; here the loss must keep one: every sum or mean over
the node axis goes through `sharded.psum` (a mean over the global batch
is a psum'd sum over the global row count), so that every rank computes
the same loss. The psum's backward pass is a psum, and the step averages
the gradients over the data axis, so each rank ends with the
single-device gradient, also for a term that depends on the parameters
alone.
"""

from __future__ import annotations

from typing import Callable

import torch

from eigenpinns_torch.parallel.mesh import Mesh, Sharding
from eigenpinns_torch.parallel.sharded import (
    all_gather,
    average_gradients,
)


def _params_of(optimizer) -> list:
    if hasattr(optimizer, "param_groups"):
        return [p for g in optimizer.param_groups for p in g["params"]]
    return list(optimizer.params)


def make_dp_train_step(
    loss_fn: Callable,        # batch -> scalar loss (node sums via psum)
    optimizer,                # torch.optim optimizer or the port's Adam
    mesh: Mesh,
    batch_spec: str | None = "data",
) -> Callable:
    """Build a DP train step: parameters (the optimizer's) replicated,
    the batch this rank's rows of the `batch_spec` axis (None: the whole
    batch on every rank).

    Returns step(batch) -> loss; the parameters are updated in place.
    """
    params = _params_of(optimizer)
    axis = batch_spec if batch_spec is not None else mesh.axis_names[0]

    def step(batch):
        for p in params:
            p.grad = None
        loss = loss_fn(batch)
        loss.backward()
        average_gradients(params, mesh, axis)
        optimizer.step()
        return loss.detach()

    return step


def constrain(x: torch.Tensor, mesh: Mesh, spec) -> torch.Tensor:
    """Lay out x as `spec` says (a `Sharding`, an axis name, or None for
    replicated): a replicated spec all-gathers this rank's rows into the
    whole array (differentiable); an axis keeps this rank's rows of a
    whole array."""
    axis = spec.axis if isinstance(spec, Sharding) else spec
    if axis is None:
        return all_gather(x, mesh, mesh.axis_names[0])
    per = x.shape[0] // mesh.axis_size(axis)
    i = mesh.axis_index(axis)
    return x[i * per:(i + 1) * per]
