"""The plain reference: what the timed path should produce, from the
inputs the benchmark made, in plain PyTorch and numpy. It imports
nothing of the program.

Training: the joint eigen-network (an MLP with SiLU, flax's Dense
layout), the penalty-mode loss of scripts/simplified_loss.ipynb
(residual + w_orth ||U^T M U - I||^2 / k + w_trace mean(lambda)) and
optax's Adam on an exponentially decaying rate, followed for the first
`REF_STEPS` steps in float32 with TF32 off. `quant` puts a lower
precision in the place of the configuration's bf16 parts (the MLP's
products and the loss operator's product): `fp8` for the control,
`bf16` for the rounding that the configuration itself makes.

Solve: the scaled eigen-residual and the M-orthonormality of returned
eigenpairs, in float64 on the host, and their eigenvalues against the
lowest eigenvalues of (K, M) by scipy's shift-invert Lanczos.
"""

from __future__ import annotations

import contextlib

import numpy as np
import scipy.sparse as sp
import torch

REF_STEPS = 3
B1, B2, EPS = 0.9, 0.999, 1e-8
FP8_MAX = 448.0   # largest finite float8_e4m3fn


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale (its largest
    magnitude maps to the format's largest finite value), back in x's
    type."""
    scale = x.detach().abs().max().clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bfloat16, back in x's type."""
    return x.to(torch.bfloat16).to(x.dtype)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


class _QMatmul(torch.autograd.Function):
    """a @ b with both factors rounded by `quant`, forward and backward
    (the backward's products round the incoming gradient too)."""

    @staticmethod
    def forward(ctx, a, b, quant):
        qa, qb = quant(a), quant(b)
        ctx.save_for_backward(qa, qb)
        ctx.quant = quant
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = ctx.quant(g)
        return qg @ qb.T, qa.T @ qg, None


class _SpMM(torch.autograd.Function):
    """A @ U for a torch sparse CSR A; the backward applies A^T."""

    @staticmethod
    def forward(ctx, U, A, At, quant):
        ctx.At, ctx.quant = At, quant
        return torch.sparse.mm(A, quant(U))

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.At, ctx.quant(g)), None, None, None


def torch_csr(A: sp.spmatrix, device, quant=identity) -> torch.Tensor:
    """A scipy matrix as a float32 torch CSR tensor, its values rounded by
    `quant`."""
    A = A.tocsr()
    vals = quant(torch.as_tensor(A.data, dtype=torch.float32))
    return torch.sparse_csr_tensor(
        torch.as_tensor(A.indptr, dtype=torch.int64),
        torch.as_tensor(A.indices, dtype=torch.int64), vals, A.shape,
        dtype=torch.float32).to(device)


@contextlib.contextmanager
def full_fp32():
    """float32 products in float32: TF32 off for the duration."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def mlp(params: dict, X: torch.Tensor, n_layers: int, quant) -> torch.Tensor:
    """The MLP: `n_layers` - 1 hidden layers with SiLU, a linear head.
    params[f'w{i}'] is (in, out), params[f'b{i}'] (out,)."""
    h = X
    for i in range(n_layers):
        h = _QMatmul.apply(h, params[f"w{i}"], quant) + params[f"b{i}"]
        if i < n_layers - 1:
            h = torch.nn.functional.silu(h)
    return h


def loss_terms(U, KU, m, w: dict, rows: int | None = None):
    """(total, {loss, res, orth, lam_mean}) of the penalty-mode loss of U
    and its product KU = K U. `rows`: the loss over U's first `rows` rows
    only (KU holds those rows of K U)."""
    k = U.shape[1]
    if rows is not None:
        U, m = U[:rows], m[:rows]
    MU = m[:, None] * U
    Gk, Gm = U.T @ KU, U.T @ MU
    lam = torch.diagonal(Gk) / (torch.diagonal(Gm) + 1e-12)
    res = ((KU - MU * lam[None, :]) ** 2).mean()
    orth = ((Gm - torch.eye(k, dtype=U.dtype, device=U.device)) ** 2
            ).sum() / k
    total = w["w_res"] * res + w["w_orth"] * orth + w["w_trace"] * lam.mean()
    return total, {"loss": total, "res": res, "orth": orth,
                   "lam_mean": lam.mean()}


def lr_at(t: int, lr_start: float, lr_end: float, epochs: int) -> float:
    """optax.exponential_decay(lr_start, epochs, lr_end / lr_start) at t
    updates made before."""
    return lr_start * (lr_end / lr_start) ** (t / epochs)


FAULTS = ("half_rows", "zeroed_mode", "frozen")


def train_steps(params0: dict, X, K: sp.spmatrix, m: np.ndarray, cfg: dict,
                device, quant=identity, steps: int = REF_STEPS,
                fault: str | None = None) -> dict:
    """The first `steps` training steps from params0 (float32 tensors,
    left unchanged): {'history': {term: [value at each step]}, 'grad':
    {leaf: first gradient}, 'change': {leaf: params after `steps`
    updates - params0}}, on the host. `fault` plants one of FAULTS in the
    reference: 'half_rows' (the loss over the first half of the rows),
    'zeroed_mode' (the network's first output column set to zero where
    it is produced), 'frozen' (no update)."""
    if fault not in (None, *FAULTS):
        raise ValueError(f"fault must be one of {FAULTS}, got {fault}")
    n_layers = len(cfg["hidden"]) + 1
    rows = X.shape[0] // 2 if fault == "half_rows" else None
    with full_fp32():
        Kr = K if rows is None else K.tocsr()[:rows]
        A, At = torch_csr(Kr, device, quant), torch_csr(Kr.T, device, quant)
        Xd = torch.as_tensor(X, dtype=torch.float32, device=device)
        md = torch.as_tensor(m, dtype=torch.float32, device=device)
        params = {key: v.detach().to(device, torch.float32, copy=True)
                  .requires_grad_(True) for key, v in params0.items()}
        mu = {key: torch.zeros_like(v) for key, v in params.items()}
        nu = {key: torch.zeros_like(v) for key, v in params.items()}
        history = {"loss": [], "res": [], "orth": [], "lam_mean": []}
        grad = None
        for t in range(steps):
            U = mlp(params, Xd, n_layers, quant)
            if fault == "zeroed_mode":
                U = torch.cat([torch.zeros_like(U[:, :1]), U[:, 1:]], 1)
            KU = _SpMM.apply(U, A, At, quant)
            total, terms = loss_terms(U, KU, md, cfg, rows)
            for key, v in terms.items():
                history[key].append(float(v.detach()))
            g = dict(zip(params, torch.autograd.grad(
                total, list(params.values()))))
            if grad is None:
                grad = {key: v.detach().cpu() for key, v in g.items()}
            if fault == "frozen":
                continue
            lr = lr_at(t, cfg["lr_start"], cfg["lr_end"], cfg["epochs"])
            with torch.no_grad():
                for key, p in params.items():
                    mu[key].mul_(B1).add_(g[key], alpha=1 - B1)
                    nu[key].mul_(B2).add_(g[key] * g[key], alpha=1 - B2)
                    mu_hat = mu[key] / (1 - B1 ** (t + 1))
                    nu_hat = nu[key] / (1 - B2 ** (t + 1))
                    p.sub_(lr * mu_hat / (nu_hat.sqrt() + EPS))
        change = {key: p.detach().cpu() - params0[key].detach().cpu().float()
                  for key, p in params.items()}
    return {"history": history, "grad": grad, "change": change}


def eigen_judge(lam: np.ndarray, V: np.ndarray, K: sp.spmatrix,
                m: np.ndarray) -> dict:
    """Of eigenpairs (lam (k,), V (n, k), in the rows of K) in float64:
    'resid', the largest ||K v - lam M v||_{M^-1} / ((1 + |lam|)
    ||v||_M), and 'orth', the largest entry of |V^T M V - I|."""
    V = np.asarray(V, dtype=np.float64)
    lam = np.asarray(lam, dtype=np.float64)
    MV = m[:, None] * V
    R = K @ V - MV * lam[None, :]
    r_norm = np.sqrt((R * R / m[:, None]).sum(0))
    v_norm = np.sqrt((V * MV).sum(0))
    G = V.T @ MV
    nums = {"resid": (r_norm / ((1 + np.abs(lam)) * v_norm)).max(),
            "orth": np.abs(G - np.eye(V.shape[1])).max()}
    # A number that cannot be read (NaN) is over every limit.
    return {key: float(np.nan_to_num(v, nan=np.inf)) for key, v in nums.items()}


def lowest_eigenvalues(K: sp.spmatrix, m: np.ndarray, k: int) -> np.ndarray:
    """The k lowest eigenvalues of K u = lam diag(m) u, ascending: scipy's
    Lanczos on (K - sigma M)^-1 M, sigma just below the spectrum (K is
    positive semi-definite), in float64."""
    from scipy.sparse.linalg import eigsh

    v0 = np.random.default_rng(0).standard_normal(K.shape[0])
    vals = eigsh(sp.csc_matrix(K), k=k, M=sp.diags(m).tocsc(), sigma=-0.01,
                 which="LM", v0=v0, return_eigenvectors=False)
    return np.sort(vals)


def eigenvalue_gap(lam: np.ndarray, lam_ref: np.ndarray) -> float:
    """The largest |lam_i - lam_ref_i| / (1 + |lam_ref_i|) of two ascending
    lists of eigenvalues; infinity where `lam` is short or unreadable."""
    lam = np.sort(np.asarray(lam, dtype=np.float64))
    if lam.shape[0] < lam_ref.shape[0]:
        return float("inf")
    gap = np.abs(lam[:lam_ref.shape[0]] - lam_ref) / (1 + np.abs(lam_ref))
    return float(np.nan_to_num(gap.max(), nan=np.inf))
