"""Node-sharded LOBPCG — the distributed solver path.

Port of `eigenpinns_tpu/solvers/lobpcg_sharded.py`: eigenvector blocks
are row-sharded over the mesh's data axis, K U / M U ride the
halo-banded sharded SpMM (`parallel/sharded_banded.py`, cluster-split
remainder at 1M scale), and every node-axis reduction (Grams, column
norms, Rayleigh quotients) is a local partial + psum: the operators are
`FunctionOperator`s that carry the psum, and `solvers/lobpcg.py` takes
its reductions from them (`node_reduce`). The 3k x 3k eigensolve runs
alike on every rank. The iteration itself is `solvers/lobpcg.py`, so
the deflation constraint and `lobpcg_blocked`'s many-mode sweeps work
sharded unchanged.

Called on every rank of an initialized group with the same host inputs;
every rank returns the same eigenpairs, vectors in the caller's order.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from eigenpinns_torch.parallel.mesh import shard_array
from eigenpinns_torch.parallel.sharded import psum
from eigenpinns_torch.solvers.direct_sharded import (
    ShardedProblem,
    prepare_sharded_problem,
    to_caller_order,
)
from eigenpinns_torch.sparse.ops import FunctionOperator


def sharded_operators(prob: ShardedProblem, K, M):
    """FunctionOperator pair over the sharded SpMMs: this rank's rows of
    the diagonals in the permuted + padded layout, the psum over the
    data axis as their node-axis reduction."""
    n, n_pad, perm, mesh = prob.n, prob.n_pad, prob.perm, prob.mesh
    first = mesh.axis_index("data") * prob.per
    red = functools.partial(psum, mesh=mesh, axis="data")
    dK = np.zeros(n_pad, np.float32)
    dK[:n] = np.asarray(K.tocsr().diagonal(), np.float32)[perm]
    dM = np.zeros(n_pad, np.float32)
    dM[:n] = np.asarray(M.tocsr().diagonal(), np.float32)[perm]
    kw = dict(reduce=red, n=n, rows=(first, n_pad))
    Kop = FunctionOperator(prob.spmm_K, shard_array(dK, mesh, "data"), **kw)
    Mop = FunctionOperator(prob.spmm_M, shard_array(dM, mesh, "data"), **kw)
    return Kop, Mop


def lobpcg_sharded(
    K,
    M,
    k: int,
    mesh=None,
    n_devices: int | None = None,
    X=None,
    X0: np.ndarray | None = None,
    block: int = 0,
    guard: int = 4,
    max_iter: int = 200,
    tol: float = 1e-6,
    seed: int = 0,
    max_bandwidth: int = 4096,
    window: int = 1024,
    problem: ShardedProblem | None = None,
    checkpoint_dir: str = "",
    log_fn=None,
    device="cuda",
):
    """Smallest-k generalized eigenpairs of scipy (K, M), node-sharded.

    `X` ((n, 3) coordinates) enables the cluster ordering fallback for
    operators whose RCM stencil does not fit a one-neighbor halo.
    `X0` ((n, >= k), CALLER vertex order) warm-starts the block(s);
    without it the block is drawn from a `torch.Generator` on the host
    seeded with `seed` (alike on every rank; the JAX package draws from
    `jax.random`), its first column set to 1. `block` > 0 switches to
    deflated sweeps (`lobpcg_blocked`, its guard columns drawn from a
    generator on the device seeded with `seed`) for large k;
    `checkpoint_dir` then keeps one checkpoint per rank (`rank<i>of<n>`:
    each holds its rows). Returns (eigenvalues (k,), eigenvectors (n, k)
    in the caller's vertex order, residual_norms (k,)). Without `mesh`
    the mesh is made over the initialized group on `device`.
    """
    from eigenpinns_torch.solvers.lobpcg import lobpcg, lobpcg_blocked

    prob = problem if problem is not None else prepare_sharded_problem(
        K, M, X=X, mesh=mesh, n_devices=n_devices,
        max_bandwidth=max_bandwidth, window=window, device=device)
    n, n_pad, perm, mesh = prob.n, prob.n_pad, prob.perm, prob.mesh
    Kop, Mop = sharded_operators(prob, K, M)

    def _pad_shard(V):
        Vp = np.zeros((n_pad, V.shape[1]), np.float32)
        Vp[:n] = np.asarray(V, np.float32)[perm]
        return shard_array(Vp, mesh, "data")

    if X0 is not None:
        X0p = _pad_shard(X0)
    else:
        width = k if not block else max(k, block + guard)
        X0h = torch.randn((n, width), generator=torch.Generator(
            "cpu").manual_seed(seed)).numpy()
        X0h[:, 0] = 1.0          # rigid-body mode of closed surfaces
        X0p = _pad_shard(X0h)

    if block:
        ckpt = ""
        if checkpoint_dir:
            ckpt = os.path.join(checkpoint_dir, f"rank{mesh.axis_index()}of"
                                f"{mesh.axis_size()}")
        vals, vecs, resids = lobpcg_blocked(
            Kop, Mop, k, block=block, guard=guard, max_iter=max_iter,
            tol=tol, X0_full=X0p, checkpoint_dir=ckpt, log_fn=log_fn,
            generator=torch.Generator(mesh.device).manual_seed(seed))
        vecs = torch.as_tensor(vecs, device=mesh.device)
    else:
        res = lobpcg(Kop, Mop, X0p[:, :k], k=k, max_iter=max_iter, tol=tol)
        vals = res.eigenvalues.cpu().numpy()
        vecs = res.eigenvectors
        resids = res.residual_norms.cpu().numpy()
    return vals, to_caller_order(vecs, prob), resids

