"""Dirichlet Laplace/Poisson solves on meshes and clouds.

Port of `eigenpinns_tpu/solvers/poisson.py` (`Mesh.computeLaplace`,
src/Mesh.py:307-346): solve K u = f with prescribed values on a
Dirichlet node set. `solve_laplace_dirichlet` is the host path, the
JAX package's (scipy `spsolve` on the interior rows), except that it
takes the interior block by rows, then columns: the JAX package's
`K[np.ix_(interior, interior)]` makes scipy build a dense index grid of
interior^2 entries (3.6e9 at 60k nodes);
`solve_laplace_dirichlet_device` is the masked CG of
`eigenpinns_tpu/solvers/poisson.py:41-88` on the port's `spmm`, so on a
strip-BSR K every iteration launches the strip-BSR kernel at k = 1. Its
`cg_iters` iterations run with no host read inside the loop (the JAX
package's `lax.fori_loop`).
"""

from __future__ import annotations

import numpy as np
import torch
from scipy.sparse.linalg import spsolve

from eigenpinns_torch.sparse.ops import spmv


def solve_laplace_dirichlet(K, boundary_idx, boundary_vals,
                            f=None) -> np.ndarray:
    """u with u[boundary] = vals and (K u)|interior = f|interior."""
    n = K.shape[0]
    K = K.tocsr()
    boundary_idx = np.asarray(boundary_idx, dtype=np.int64)
    boundary_vals = np.asarray(boundary_vals, dtype=np.float64)
    mask = np.ones(n, dtype=bool)
    mask[boundary_idx] = False
    interior = np.where(mask)[0]

    rhs = np.zeros(n) if f is None else np.asarray(f, dtype=np.float64)
    u = np.zeros(n)
    u[boundary_idx] = boundary_vals

    K_i = K[interior]
    K_ii = K_i[:, interior].tocsc()
    K_ib = K_i[:, boundary_idx]
    b = rhs[interior] - K_ib @ boundary_vals
    u[interior] = spsolve(K_ii, b)
    return u


@torch.no_grad()
def solve_laplace_dirichlet_device(K_op, boundary_mask, boundary_vals,
                                   f=None, cg_iters: int = 400,
                                   ridge: float = 0.0) -> torch.Tensor:
    """Masked CG on the full operator, on K_op's device.

    CG runs on A = P K P + I_boundary with P = diag(interior): SPD on the
    whole space, the boundary components decoupled as the identity.
    boundary_mask: (N,) bool; boundary_vals: (N,) with the values at the
    boundary (ignored elsewhere). Returns u (N,) in boundary_vals' dtype.
    """
    vals = torch.as_tensor(boundary_vals)
    device = K_op.diagonal().device
    vals = vals.to(device)
    mask = torch.as_tensor(boundary_mask, device=device)
    rhs = (torch.zeros_like(vals) if f is None
           else torch.as_tensor(f, dtype=vals.dtype, device=device))
    interior = ~mask
    zero = torch.zeros((), dtype=vals.dtype, device=device)

    def matvec(u):
        pu = torch.where(interior, u, zero)
        out = spmv(K_op, pu) + ridge * pu
        return torch.where(interior, out, u)

    u_b = torch.where(mask, vals, zero)
    b = torch.where(interior, rhs - spmv(K_op, u_b), zero)
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = r
    rs = r @ r
    for _ in range(cg_iters):
        Ap = matvec(p)
        alpha = rs / torch.clamp(p @ Ap, min=1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = r @ r
        beta = rs_new / torch.clamp(rs, min=1e-30)
        p = r + beta * p
        rs = rs_new
    return torch.where(mask, vals, x)
