"""Dense k x k generalized eigensolves and Rayleigh-Ritz refinement.

Port of `eigenpinns_tpu/solvers/rayleigh_ritz.py`: the k x k problem
stays on the operator's device (Cholesky reduction, or spectral-filtered
whitening when the mass Gram may be near-singular). The Grams sum over
every shard of a sharded operator's rows (`node_reduce`).

Each dense eigensolve goes through `eigh`, which routes it by what the
input shows (`small_eigh.kernel_route`): a 2-D CUDA fp32/fp64 matrix of
n <= 84 that autograd is not recording goes to the hand-written kernel
(`csrc/small_eigh.cu`, one launch, no host sync), everything else to
`torch.linalg.eigh` (which on CUDA checks its result on the host). A
caller that passes a status word (`lobpcg`) reads the kernel's failures
itself when it next reads the card; without one, `eigh` reads it at once
and raises `torch.linalg.LinAlgError` as the library does.

Each k x k Gram runs in a `lobpcg.gram` span (`node_gram`) and each dense
eigensolve in a `lobpcg.eigh` span (`eigh`). The counters: `eigh.kernel`
for each solve on the kernel, `sync.eigh` for the host's waits at the
eigensolves (one a library solve on CUDA or CPU and one a kernel solve
without a status word, 0 with one).
"""

from __future__ import annotations

import torch

from eigenpinns_torch.solvers.small_eigh import kernel_route, small_eigh_cuda
from eigenpinns_torch.sparse.ops import gram, hdot, node_reduce, spmm
from eigenpinns_torch.utils.profiling import count, span


def node_gram(M, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """U^T V summed over every shard of M's rows."""
    with span("lobpcg.gram"):
        return node_reduce(M, gram(U, V))


def eigh(A: torch.Tensor, status: torch.Tensor | None = None):
    """(eigenvalues ascending, eigenvectors) of the symmetric A from its
    lower triangle: on the kernel where `small_eigh.kernel_route` takes A,
    else `torch.linalg.eigh`. On the kernel a failure makes both outputs
    NaN and sets `status` (an int32 scalar on A's device) to 1, read by
    the caller; without `status` it raises LinAlgError after one host
    read."""
    with span("lobpcg.eigh"):
        if not kernel_route(A.device.type, tuple(A.shape), A.dtype,
                            A.requires_grad and torch.is_grad_enabled()):
            count("sync.eigh")
            return torch.linalg.eigh(A)
        count("eigh.kernel")
        if status is not None:
            count("sync.eigh", 0)
            return small_eigh_cuda(A, status)
        count("sync.eigh")
        status = torch.zeros((), dtype=torch.int32, device=A.device)
        w, V = small_eigh_cuda(A, status)
        if status.item():
            raise torch.linalg.LinAlgError(
                "eigh: the input is not finite or the solve did not "
                "converge")
        return w, V


def eigh_generalized(A: torch.Tensor, B: torch.Tensor, jitter: float = 0.0):
    """Solve A C = B C diag(w), A symmetric, B SPD. Returns (w, C)
    ascending, via B = L L^T and the standard problem L^-1 A L^-T."""
    k = A.shape[0]
    if jitter:
        B = B + jitter * torch.eye(k, dtype=B.dtype, device=B.device)
    L = torch.linalg.cholesky(B)
    Y = torch.linalg.solve_triangular(L, A, upper=False)
    C_std = torch.linalg.solve_triangular(L, Y.T, upper=False).T
    C_std = 0.5 * (C_std + C_std.T)
    w, V = eigh(C_std)
    return w, torch.linalg.solve_triangular(L.T, V, upper=True)


def filtered_whiten(S: torch.Tensor, G: torch.Tensor, eps: float = 1e-6,
                    status: torch.Tensor | None = None):
    """Spectral B-whitening of a basis S with Gram G = S^T B S.

    Returns (S W, good, W) with W = V diag(e^-1/2) from G's
    eigendecomposition (`eigh`, with `status`); `good` marks the
    directions kept (e > eps * e_max). Dropped directions become zero
    columns.
    """
    G = 0.5 * (G + G.T)
    e, V = eigh(G, status)
    good = e > eps * torch.clamp(e[-1], min=1e-30)
    inv = torch.where(good, torch.rsqrt(torch.clamp(e, min=1e-30)),
                      torch.zeros_like(e))
    Wh = V * inv[None, :]
    return hdot(S, Wh), good, Wh


def rayleigh_ritz(U: torch.Tensor, K, M, jitter: float = 0.0):
    """Solve the projected problem (U^T K U, U^T M U) and rotate U
    (src/multigrid_model.py:386-408)."""
    A = node_gram(M, U, spmm(K, U))
    B = node_gram(M, U, spmm(M, U))
    w, C = eigh_generalized(0.5 * (A + A.T), 0.5 * (B + B.T), jitter=jitter)
    return w, hdot(U, C)


def rayleigh_ritz_robust(U: torch.Tensor, K, M, eps: float = 1e-6):
    """Rayleigh-Ritz with spectral filtering of the mass Gram: dependent
    directions are dropped and their Ritz values pushed to a sentinel."""
    B = node_gram(M, U, spmm(M, U))
    Uw, good, _ = filtered_whiten(U, B, eps=eps)
    A = node_gram(M, Uw, spmm(K, Uw))
    A = 0.5 * (A + A.T)
    big = 10.0 * A.diagonal().abs().max() + 1.0
    A = A + torch.diag(torch.where(good, torch.zeros_like(big), big))
    w, V = eigh(A)
    return w, hdot(Uw, V)
