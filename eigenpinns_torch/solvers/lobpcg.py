"""Generalized LOBPCG for the smallest-k eigenpairs of K u = lambda M u.

Port of `eigenpinns_tpu/solvers/lobpcg.py` (Knyazev's LOBPCG with
B-inner-product Rayleigh-Ritz on [X, W, P], spectral-filtered whitening,
Jacobi preconditioning). The JAX `lax.while_loop` exits on tolerance
without a host sync. Here every iteration runs under an on-device
`active` flag that freezes the state once max(res) <= tol, and the host
reads the flag only every `_CHECK_EVERY` iterations: the iteration count
is that of the JAX loop, at one sync per `_CHECK_EVERY` iterations.

Two departures from the JAX iteration, both the same iteration in exact
arithmetic (ROADMAP queue 3):

  * a warm start's whitened-away directions are flagged dropped (F5);
  * the residual R = K X - M X diag(lam) and the returned eigenvalues use
    the Rayleigh quotients of X, computed from the K X and M X products
    the iteration has anyway, not the eigenvalues of the fp32 Gram
    S^T K S (F9). In fp32 those Gram eigenvalues carry an error far
    above the Rayleigh quotients' on large clouds (1e-3 against 3e-6
    relative on a 20k-point Laplacian), so a residual built from them
    has a floor and the iteration stalls there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from eigenpinns_torch.sparse.ops import gram, hdot, spmm
from eigenpinns_torch.solvers.rayleigh_ritz import filtered_whiten

_CHECK_EVERY = 10   # iterations between host reads of the stop flag


class LobpcgResult(NamedTuple):
    eigenvalues: torch.Tensor     # (k,)
    eigenvectors: torch.Tensor    # (N, k), M-orthonormal
    iterations: torch.Tensor      # ()
    residual_norms: torch.Tensor  # (k,) ||K u - lam M u|| / max(1, |lam|)


def _sentinel(A: torch.Tensor) -> torch.Tensor:
    """Ritz-value sentinel for dropped directions: 10x the largest
    Rayleigh quotient of the basis (see the JAX module)."""
    return 10.0 * A.diagonal().abs().max() + 1.0


def _b_orthonormalize(X, M, eps):
    """Spectral M-orthonormalization of a block; dropped directions -> 0."""
    d = torch.sqrt(torch.clamp((X * spmm(M, X)).sum(0), min=0.0))
    X = X * torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30),
                        torch.zeros_like(d))[None, :]
    Xw, good, _ = filtered_whiten(X, gram(X, spmm(M, X)), eps=eps)
    # In fp32 the whitening of an exactly dependent block can keep a
    # noise direction (its Gram eigenvalue sits just above eps * e_max)
    # whose M-norm comes out far from 1; in the Rayleigh-Ritz step such a
    # column poses as a spurious tiny Ritz value. Drop it like the
    # filtered ones. Well-conditioned blocks are unchanged.
    good = good & (((Xw * spmm(M, Xw)).sum(0) - 1.0).abs() < 0.5)
    return Xw * good[None, :], good


def _rayleigh_quotients(X, KX, MX):
    """x^T K x / x^T M x per column; 0 for the zero columns of dropped
    directions."""
    den = (X * MX).sum(0)
    return (X * KX).sum(0) / torch.where(den > 0, den, torch.ones_like(den))


def _project_out(Y, X, MX):
    """Y - X (X^T M Y), applied twice for f32 robustness."""
    Y = Y - hdot(X, gram(MX, Y))
    return Y - hdot(X, gram(MX, Y))


@torch.no_grad()
def lobpcg(K, M, X0: torch.Tensor, k: int | None = None,
           max_iter: int = 200, tol: float = 1e-6, whiten_eps: float = 1e-8,
           Y: torch.Tensor | None = None) -> LobpcgResult:
    """Smallest-k generalized eigenpairs from initial block X0 (N, k).

    `Y` (N, j), M-orthonormal: deflation constraints — the iteration
    stays in the M-orthogonal complement of span(Y).
    """
    if k is None:
        k = X0.shape[1]
    precond = 1.0 / torch.clamp(K.diagonal(), min=1e-12)
    MY = spmm(M, Y) if Y is not None else None

    def _deflate(V):
        return _project_out(V, Y, MY) if Y is not None else V

    def body(X, P, good_x):
        MX = spmm(M, X)
        KX = spmm(K, X)
        lam = _rayleigh_quotients(X, KX, MX)
        R = KX - MX * lam[None, :]
        res = torch.linalg.vector_norm(R, dim=0) / torch.clamp(
            lam.abs(), min=1.0)
        W = precond[:, None] * R
        W = _project_out(_deflate(W), X, MX)
        W, good_w = _b_orthonormalize(W, M, whiten_eps)
        MW = spmm(M, W)
        P = _project_out(_project_out(_deflate(P), X, MX), W, MW)
        P, good_p = _b_orthonormalize(P, M, whiten_eps)

        S = torch.cat([X, W, P], dim=1)            # (N, 3k)
        A = gram(S, spmm(K, S))
        good = torch.cat([good_x, good_w, good_p])
        A = 0.5 * (A + A.T)
        A = A + torch.diag(torch.where(good, torch.zeros((), device=A.device),
                                       _sentinel(A)))
        w, V = torch.linalg.eigh(A)
        C = V[:, :k]
        C_wp = C.clone()
        C_wp[:k] = 0.0                              # W/P contribution only
        # A selected Ritz vector is good when it lies in the kept
        # directions (its unit coefficient vector weighs > 1/2 there).
        good_x = (C[good] ** 2).sum(0) > 0.5
        return hdot(S, C), hdot(S, C_wp), res, good_x

    # Directions of X0 that the whitening drops (a rank-deficient warm
    # start, e.g. a collapsed learned subspace) are zero columns. The JAX
    # package keeps them flagged good, so they come back as Ritz pairs
    # (0, 0) and never leave the block; here they are flagged as dropped,
    # the sentinel moves them out, and W/P directions take their place.
    # For a full-rank X0 the two are the same iteration.
    X, good_x = _b_orthonormalize(_deflate(X0), M, whiten_eps)
    P = torch.zeros_like(X)
    it = torch.zeros((), dtype=torch.int64, device=X.device)
    res = torch.full((k,), float("inf"), dtype=X.dtype, device=X.device)
    for i in range(max_iter):
        active = res.max() > tol
        X_n, P_n, res_n, good_n = body(X, P, good_x)
        X = torch.where(active, X_n, X)
        P = torch.where(active, P_n, P)
        res = torch.where(active, res_n, res)
        good_x = torch.where(active, good_n, good_x)
        it = it + active.to(it.dtype)
        if (i + 1) % _CHECK_EVERY == 0 and not bool(res.max() > tol):
            break

    KX, MX = spmm(K, X), spmm(M, X)
    lam = _rayleigh_quotients(X, KX, MX)
    R = KX - MX * lam[None, :]
    res = torch.linalg.vector_norm(R, dim=0) / torch.clamp(lam.abs(),
                                                           min=1.0)
    return LobpcgResult(lam, X, it, res)


def lobpcg_from_random(K, M, k: int, generator: torch.Generator | None = None,
                       dtype=torch.float32, **kw) -> LobpcgResult:
    """Random init (plus the constant vector, which spans the lambda=0
    rigid-body mode of closed-surface Laplacians)."""
    device = K.diagonal().device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    X0 = torch.randn((K.shape[0], k), generator=generator, dtype=dtype,
                     device=device)
    X0[:, 0] = 1.0
    return lobpcg(K, M, X0, k=k, **kw)
