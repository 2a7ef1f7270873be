"""Generalized LOBPCG for the smallest-k eigenpairs of K u = lambda M u.

Port of `eigenpinns_tpu/solvers/lobpcg.py` (Knyazev's LOBPCG with
B-inner-product Rayleigh-Ritz on [X, W, P], spectral-filtered whitening,
Jacobi preconditioning). The JAX `lax.while_loop` exits on tolerance
without a host sync. Here every iteration runs under an on-device
`active` flag that freezes the state once max(res) <= tol, and the host
reads the flag only every `_CHECK_EVERY` iterations, so the iteration
count is that of the JAX loop. On CUDA an iteration makes no other host
read: its three eigensolves (the Rayleigh-Ritz step's at 3k, the two
whitenings' at k in `rayleigh_ritz.filtered_whiten`) run on the
hand-written kernel up to n = 84 (`solvers/small_eigh.py`), which
records a failure in the call's status word on the card instead of
checking it on the host; the stop check reads that word in the same
transfer as the stop flag and raises `torch.linalg.LinAlgError` for a
failed solve. The selection of the good Ritz vectors is a masked sum of
fixed shape. (Wider problems, 3k > 84, take `torch.linalg.eigh`, which
checks each result on the host.) Each call is a `lobpcg` span; its Grams,
eigensolves and products are spans inside it, and each host sync is
counted by its site (`sync.eigh`, `sync.select`, `sync.stop_check`; 0 for
a site that no longer waits) and each kernel eigensolve by `eigh.kernel`
(`utils/profiling.py`).

`lobpcg_blocked` runs it in deflated sweeps for large mode counts.

Every sum over the node axis (column norms, Rayleigh quotients, Grams)
goes through `node_reduce(M, .)`: on the sharded operators of
`solvers/lobpcg_sharded.py` it is the all-reduce over the mesh's data
axis, so the same iteration runs on row-sharded blocks; elsewhere it is
the local sum.

Departures from the JAX iteration (ROADMAP queue 3). The first three
are the same iteration in exact arithmetic; the fourth is an added step:

  * a warm start's whitened-away directions are flagged dropped (F5);
  * the residual R = K X - M X diag(lam) and the returned eigenvalues use
    the Rayleigh quotients of X, computed from the K X and M X products
    the iteration has anyway, not the eigenvalues of the fp32 Gram
    S^T K S (F9). In fp32 those Gram eigenvalues carry an error far
    above the Rayleigh quotients' on large clouds (1e-3 against 3e-6
    relative on a 20k-point Laplacian), so a residual built from them
    has a floor and the iteration stalls there;
  * the Rayleigh-Ritz eigh runs in fp64 (F11). The W directions carry
    Rayleigh quotients near the top of the spectrum, so fp32 eigh of
    S^T K S errs by more than the gap of a near-degenerate pair and
    returns an arbitrary rotation of the pair;
  * `lobpcg_blocked` ends with one fp64 Rayleigh-Ritz over all its
    sweeps' modes and the last sweep's guard columns (F11), a projection
    the JAX package does not make: a pair split across two sweeps is
    mixed otherwise. It changes the returned vectors whenever a sweep
    stopped short of convergence.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import warnings
from typing import NamedTuple

import numpy as np
import torch

from eigenpinns_torch.sparse.ops import hdot, node_reduce, spmm
from eigenpinns_torch.solvers.rayleigh_ritz import (
    eigh,
    eigh_generalized,
    filtered_whiten,
    node_gram,
)
from eigenpinns_torch.utils.profiling import count, span

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


def _b_orthonormalize(X, M, eps, status=None):
    """Spectral M-orthonormalization of a block; dropped directions -> 0.
    `status`: the eigensolve's failure word (`rayleigh_ritz.eigh`)."""
    d = torch.sqrt(torch.clamp(node_reduce(M, (X * spmm(M, X)).sum(0)),
                               min=0.0))
    X = X * torch.where(d > 0, 1.0 / torch.clamp(d, min=1e-30),
                        torch.zeros_like(d))[None, :]
    Xw, good, _ = filtered_whiten(X, node_gram(M, X, spmm(M, X)), eps=eps,
                                  status=status)
    # In fp32 the whitening of an exactly dependent block can keep a
    # noise direction (its Gram eigenvalue sits just above eps * e_max)
    # whose M-norm comes out far from 1; in the Rayleigh-Ritz step such a
    # column poses as a spurious tiny Ritz value. Drop it like the
    # filtered ones. Well-conditioned blocks are unchanged.
    good = good & ((node_reduce(M, (Xw * spmm(M, Xw)).sum(0)) - 1.0).abs()
                   < 0.5)
    return Xw * good[None, :], good


def _rayleigh_quotients(X, KX, MX, M):
    """x^T K x / x^T M x per column; 0 for the zero columns of dropped
    directions."""
    den = node_reduce(M, (X * MX).sum(0))
    return (node_reduce(M, (X * KX).sum(0))
            / torch.where(den > 0, den, torch.ones_like(den)))


def _column_norms(R, M):
    """The 2-norm of each column of R over every shard of its rows."""
    if getattr(M, "reduce", None) is None:
        return torch.linalg.vector_norm(R, dim=0)
    return torch.sqrt(node_reduce(M, (R * R).sum(0)))


def _residual_norms(X, KX, MX, lam, M):
    R = KX - MX * lam[None, :]
    return _column_norms(R, M) / torch.clamp(lam.abs(), min=1.0)


def _keep_going(res, tol, status) -> bool:
    """Whether max(res) > tol: one host read, which on CUDA also reads the
    eigensolves' failure word and raises LinAlgError when it is set (the
    failed solve's NaN would otherwise read as converged)."""
    flag = res.max() > tol
    if status is None:
        return bool(flag)
    go, failed = torch.stack([flag.to(torch.int32), status]).tolist()
    if failed:
        raise torch.linalg.LinAlgError(
            "lobpcg: a dense eigensolve failed (a nonfinite Gram, or no "
            "convergence)")
    return bool(go)


def _good_ritz(C, good):
    """Which selected Ritz vectors are good: those whose unit coefficient
    vector (a column of C) weighs > 1/2 in the kept directions `good`,
    summed as a masked sum of fixed shape (no host read; the same flags
    as `(C[good] ** 2).sum(0) > 0.5`)."""
    return ((C * good[:, None]) ** 2).sum(0) > 0.5


def _project_out(Y, X, MX, M):
    """Y - X (X^T M Y), applied twice for f32 robustness."""
    Y = Y - hdot(X, node_gram(M, MX, Y))
    return Y - hdot(X, node_gram(M, MX, Y))


@torch.no_grad()
def lobpcg(K, M, X0: torch.Tensor, k: int | None = None,
           max_iter: int = 200, tol: float = 1e-6, whiten_eps: float = 1e-8,
           Y: torch.Tensor | None = None) -> LobpcgResult:
    """Smallest-k generalized eigenpairs from initial block X0 (N, k).

    `Y` (N, j), M-orthonormal: deflation constraints — the iteration
    stays in the M-orthogonal complement of span(Y).
    """
    with span("lobpcg"):
        if k is None:
            k = X0.shape[1]
        # The eigensolves' failure word on the card, read with the stop flag.
        status = (torch.zeros((), dtype=torch.int32, device=X0.device)
                  if X0.is_cuda else None)
        precond = 1.0 / torch.clamp(K.diagonal(), min=1e-12)
        MY = spmm(M, Y) if Y is not None else None

        def _deflate(V):
            return _project_out(V, Y, MY, M) if Y is not None else V

        def body(X, P, good_x):
            MX = spmm(M, X)
            KX = spmm(K, X)
            lam = _rayleigh_quotients(X, KX, MX, M)
            R = KX - MX * lam[None, :]
            res = _column_norms(R, M) / torch.clamp(lam.abs(), min=1.0)
            W = precond[:, None] * R
            W = _project_out(_deflate(W), X, MX, M)
            W, good_w = _b_orthonormalize(W, M, whiten_eps, status)
            MW = spmm(M, W)
            P = _project_out(_project_out(_deflate(P), X, MX, M), W, MW, M)
            P, good_p = _b_orthonormalize(P, M, whiten_eps, status)

            S = torch.cat([X, W, P], dim=1)            # (N, 3k)
            A = node_gram(M, S, spmm(K, S))
            good = torch.cat([good_x, good_w, good_p])
            A = 0.5 * (A + A.T)
            A = A + torch.diag(torch.where(
                good, torch.zeros((), device=A.device), _sentinel(A)))
            # fp64 eigh (F11): fp32's error, eps * |A|, reaches the gaps of
            # near-degenerate pairs once W holds high Rayleigh quotients.
            C = eigh(A.double(), status)[1][:, :k].to(A.dtype)
            C_wp = C.clone()
            C_wp[:k] = 0.0                              # W/P contribution only
            count("sync.select", 0)
            good_x = _good_ritz(C, good)
            return hdot(S, C), hdot(S, C_wp), res, good_x

        # Directions of X0 that the whitening drops (a rank-deficient warm
        # start, e.g. a collapsed learned subspace) are zero columns. The JAX
        # package keeps them flagged good, so they come back as Ritz pairs
        # (0, 0) and never leave the block; here they are flagged as dropped,
        # the sentinel moves them out, and W/P directions take their place.
        # For a full-rank X0 the two are the same iteration.
        X, good_x = _b_orthonormalize(_deflate(X0), M, whiten_eps, status)
        P = torch.zeros_like(X)
        it = torch.zeros((), dtype=torch.int64, device=X.device)
        res = torch.full((k,), float("inf"), dtype=X.dtype, device=X.device)
        checked = False     # the last iteration run read the status word
        for i in range(max_iter):
            active = res.max() > tol
            X_n, P_n, res_n, good_n = body(X, P, good_x)
            X = torch.where(active, X_n, X)
            P = torch.where(active, P_n, P)
            res = torch.where(active, res_n, res)
            good_x = torch.where(active, good_n, good_x)
            it = it + active.to(it.dtype)
            checked = (i + 1) % _CHECK_EVERY == 0
            if checked:
                count("sync.stop_check")
                if not _keep_going(res, tol, status):
                    break
        if status is not None and not checked:
            count("sync.stop_check")
            _keep_going(res, tol, status)

        KX, MX = spmm(K, X), spmm(M, X)
        lam = _rayleigh_quotients(X, KX, MX, M)
        return LobpcgResult(lam, X, it, _residual_norms(X, KX, MX, lam, M))


@torch.no_grad()
def _rayleigh_ritz_f64(K, M, V: torch.Tensor):
    """Rayleigh-Ritz of span(V) with the k x k Grams and their eigh in
    fp64: (Ritz values, rotated V, residual norms)."""
    KV, MV = spmm(K, V), spmm(M, V)
    A = node_gram(M, V.double(), KV.double())
    B = node_gram(M, V.double(), MV.double())
    C = eigh_generalized(0.5 * (A + A.T), 0.5 * (B + B.T))[1].to(V.dtype)
    V, KV, MV = hdot(V, C), hdot(KV, C), hdot(MV, C)
    lam = _rayleigh_quotients(V, KV, MV, M)
    return lam, V, _residual_norms(V, KV, MV, lam, M)


def _randn_rows(K, width: int, generator: torch.Generator, dtype,
                device) -> torch.Tensor:
    """A normal (N, width) block drawn from `generator`; on a sharded
    operator the global padded block is drawn (alike on every rank) and
    this rank's rows are kept."""
    rows = getattr(K, "rows", None)
    if rows is None:
        return torch.randn((K.shape[0], width), generator=generator,
                           dtype=dtype, device=device)
    first, n_pad = rows
    return torch.randn((n_pad, width), generator=generator, dtype=dtype,
                       device=device)[first:first + K.shape[0]]


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


def lobpcg_blocked(K, M, k_total: int, block: int = 16, guard: int = 4,
                   max_iter: int = 200, tol: float = 1e-6,
                   generator: torch.Generator | None = None,
                   dtype=torch.float32, X0_full: torch.Tensor | None = None,
                   checkpoint_dir: str = "", log_fn=None):
    """k_total smallest eigenpairs in deflated sweeps of `block` modes.

    Port of `lobpcg_blocked` (`eigenpinns_tpu/solvers/lobpcg.py`). Each
    sweep runs `lobpcg` on `block + guard` vectors, M-orthogonally
    deflated against every mode already converged (the `Y` constraint,
    a fixed-width (N, k_total) basis whose zero columns are inert), and
    keeps the first `block`. `X0_full` (N, >= k_total) warm-starts the
    kept columns of every sweep (e.g. prolongated coarse eigenvectors);
    the guard columns, and the rest without a warm start, are drawn from
    `generator` (default: one on K's device seeded with 0). The JAX
    package draws them from `jax.random`, so the two solvers agree after
    convergence, not bit for bit. The sweeps' modes, with the last
    sweep's guard columns, end with one fp64 Rayleigh-Ritz that keeps the
    lowest k_total (F11; the JAX package returns each sweep's modes as
    they are).

    `checkpoint_dir` persists every converged sweep, with the
    generator's state, to `<dir>/lobpcg_blocked.npz` (written to a temp
    file and `os.replace`d) and resumes from it on restart, giving the
    same result as an uninterrupted run. A problem fingerprint (the
    operators' leading diagonals, tol, guard, max_iter) keeps a
    checkpoint of another problem from being resumed. The file holds a
    `torch.Generator` state where the JAX package stores its PRNG key:
    neither package can read the other's checkpoint.

    Returns (eigenvalues (k_total,), eigenvectors (N, k_total),
    residual_norms (k_total,)) as numpy arrays.
    """
    n = K.shape[0]
    device = K.diagonal().device
    if generator is None:
        generator = torch.Generator(device).manual_seed(0)
    Y = torch.zeros((n, k_total), dtype=dtype, device=device)
    vals, vecs, resids = [], [], []
    b0 = 0

    ckpt_path = None
    fingerprint = ""
    if checkpoint_dir:
        os.makedirs(checkpoint_dir, exist_ok=True)
        ckpt_path = os.path.join(checkpoint_dir, "lobpcg_blocked.npz")
        h = hashlib.sha1()
        for op in (K, M):
            d = op.diagonal().detach().double().cpu().numpy()
            h.update(d[:4096].tobytes())
        h.update(np.float64([tol, guard, max_iter]).tobytes())
        fingerprint = h.hexdigest()
        if os.path.exists(ckpt_path):
            z = np.load(ckpt_path)
            if (int(z["n"]) == n and int(z["k_total"]) == k_total
                    and int(z["block"]) == block
                    and str(z["fingerprint"]) == fingerprint):
                b0 = int(z["b0"])
                if b0 > 0:
                    vals, vecs, resids = [z["vals"]], [z["vecs"]], [
                        z["resids"]]
                    Y[:, :b0] = torch.as_tensor(z["vecs"], dtype=dtype,
                                                device=device)
                generator.set_state(torch.from_numpy(z["generator"]))
            else:
                warnings.warn(
                    "lobpcg_blocked: ignoring checkpoint in "
                    f"{checkpoint_dir} (different problem/settings)",
                    stacklevel=2)

    def _save(b_next):
        fd, tmp = tempfile.mkstemp(dir=checkpoint_dir, suffix=".npz")
        os.close(fd)
        np.savez(tmp, n=n, k_total=k_total, block=block, b0=b_next,
                 fingerprint=fingerprint, vals=np.concatenate(vals),
                 vecs=np.concatenate(vecs, axis=1),
                 resids=np.concatenate(resids),
                 generator=generator.get_state().numpy())
        os.replace(tmp, ckpt_path)

    guards = None   # the guard columns of the latest sweep
    while b0 < k_total:
        keep = min(block, k_total - b0)
        kb = min(block + guard, k_total + guard - b0)
        X0 = _randn_rows(K, kb, generator, dtype, device)
        if X0_full is not None and b0 + keep <= X0_full.shape[1]:
            X0[:, :keep] = torch.as_tensor(X0_full[:, b0:b0 + keep],
                                           dtype=dtype, device=device)
        elif b0 == 0:
            X0[:, 0] = 1.0   # rigid-body mode
        res = lobpcg(K, M, X0, k=kb, max_iter=max_iter, tol=tol, Y=Y)
        vals.append(res.eigenvalues[:keep].cpu().numpy())
        vecs.append(res.eigenvectors[:, :keep].cpu().numpy())
        resids.append(res.residual_norms[:keep].cpu().numpy())
        if log_fn is not None:
            log_fn(b0, keep, res)
        Y[:, b0:b0 + keep] = res.eigenvectors[:, :keep]
        guards = res.eigenvectors[:, keep:]
        b0 += keep
        if ckpt_path is not None:
            _save(b0)
    if ckpt_path is not None:
        # A finished sweep's checkpoint must not shadow the next run.
        try:
            os.remove(ckpt_path)
        except OSError:
            pass
    # Y now holds every sweep's modes. One Rayleigh-Ritz over them and the
    # last sweep's guard columns, keeping the lowest k_total (F11): the
    # halves of a pair split at a sweep boundary, or at k_total, come back
    # unmixed.
    if guards is not None:
        Y = torch.cat([Y, guards], dim=1)
    lam, V, res = _rayleigh_ritz_f64(K, M, Y)
    return (lam[:k_total].cpu().numpy(), V[:, :k_total].cpu().numpy(),
            res[:k_total].cpu().numpy())
