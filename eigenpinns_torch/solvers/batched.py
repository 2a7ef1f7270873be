"""Batched eigen-learning over a mesh family.

Port of `eigenpinns_tpu/solvers/batched.py`: the family's operators are
stacked into one padded ELL layout (`_pack_family`), every mesh keeps its
own network parameters, and one program trains all meshes at once. The
JAX package vmaps `JointEigenNet.apply` over the stacked parameters;
here the parameters are stacked (F, in, out) in a `StackedJointEigenNet`
and each layer is one `torch.bmm`. The padded-ELL product
einsum("nwk,nw->nk", U[idx], val) is a batched gather with an fp32
contraction (TF32 is off), as the JAX package's HIGHEST-precision einsum;
in both packages it is a plain gather, not a hand kernel. Its backward
pass gathers too, on the members' stored transposes, where autograd's
would scatter-add (`index_put_` with accumulation, 91% of a step's
device time at the example's widths on an H100).

Constraints (as in the JAX package): diagonal (lumped) mass matrices;
meshes padded to the largest member (padded rows carry zero stiffness
and unit mass and are masked out of U).

Deviation (ROADMAP F19): the per-mesh LOBPCG polish runs on the learned
k columns plus `POLISH_GUARD` random guard columns and reports the
lowest k, as the single-mesh drivers' polishes do. The JAX driver
polishes the k learned columns alone, and a learned subspace that
missed one of the lowest modes keeps missing it: on an H100 the
10000-point member of the face-family stand-in once came out of training
without one of its l = 2 modes, and its polished mode 8 read the l = 3
value (rel err 0.996).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from eigenpinns_torch.models.eigennet import StackedJointEigenNet
from eigenpinns_torch.solvers.lobpcg import lobpcg
from eigenpinns_torch.solvers.rayleigh_ritz import rayleigh_ritz_robust
from eigenpinns_torch.sparse.formats import as_operator
from eigenpinns_torch.train.loop import run_chunked_loop
from eigenpinns_torch.train.optim import adam_exp_decay

# Random guard columns beside the k learned ones in the per-mesh polish
# (the deviation the module docstring names).
POLISH_GUARD = 8


@dataclasses.dataclass
class BatchedResult:
    eigenvalues: np.ndarray   # (F, k)
    eigenvectors: np.ndarray  # (F, N_pad, k); rows past a mesh's n are
                              # padding
    sizes: list
    history: dict
    chunk_times: list = dataclasses.field(default_factory=list)


def _pack_ell(mats, N: int, dtype=np.float32):
    """Stack scipy matrices of at most N rows into (F, N, W) ELL arrays
    (idx, val), W the largest row degree rounded up to 8; padding points
    at column 0 with value 0."""
    packed = []
    for A in mats:
        A = A.tocsr()
        A.sum_duplicates()
        packed.append(A)
    W = max(int(np.diff(A.indptr).max()) for A in packed)
    W = ((W + 7) // 8) * 8
    idx = np.zeros((len(packed), N, W), np.int64)
    val = np.zeros((len(packed), N, W), dtype)
    for f, A in enumerate(packed):
        deg = np.diff(A.indptr)
        rows = np.repeat(np.arange(A.shape[0]), deg)
        pos = np.arange(A.nnz) - np.repeat(A.indptr[:-1], deg)
        idx[f, rows, pos] = A.indices
        val[f, rows, pos] = A.data
    return idx, val


def _pack_family(K_list, M_list, X_list, dtype=np.float32, device="cuda"):
    """Stack scipy operators into common-shape ELL tensors: (idx, val,
    mdiag, mask, X, sizes) with idx/val (F, N, W), mdiag/mask (F, N) and
    X (F, N, d)."""
    sizes = [K.shape[0] for K in K_list]
    F, N = len(K_list), max(sizes)
    idx, val = _pack_ell(K_list, N, dtype)
    mdiag = np.ones((F, N), dtype)          # unit mass on padding
    mask = np.zeros((F, N), dtype)
    X = np.zeros((F, N, np.asarray(X_list[0]).shape[1]), dtype)
    for f, (n, M, Xf) in enumerate(zip(sizes, M_list, X_list)):
        mask[f, :n] = 1.0
        mdiag[f, :n] = M.diagonal()
        X[f, :n] = Xf

    def dev(a):
        return torch.as_tensor(a, device=device)

    return dev(idx), dev(val), dev(mdiag), dev(mask), dev(X), sizes


def _family_gather(idx: torch.Tensor, val: torch.Tensor,
                   U: torch.Tensor) -> torch.Tensor:
    """Each member's padded-ELL product: (F, N, k) from U (F, N, k)."""
    members = torch.arange(U.shape[0], device=U.device)[:, None, None]
    return torch.einsum("fnwk,fnw->fnk", U[members, idx], val)


class _FamilySpmm(torch.autograd.Function):
    """K U per member; the backward pass applies the stored K^T with the
    same gather."""

    @staticmethod
    def forward(ctx, U, idx, val, idx_t, val_t):
        ctx.save_for_backward(idx_t, val_t)
        return _family_gather(idx, val, U)

    @staticmethod
    def backward(ctx, g):
        idx_t, val_t = ctx.saved_tensors
        return _family_gather(idx_t, val_t, g), None, None, None, None


def train_joint_family(
    K_list,
    M_list,
    X_list,
    n_modes: int,
    hidden=(64, 64, 64),
    epochs: int = 3000,
    scan_chunk: int = 200,
    lr_start: float = 5e-3,
    lr_end: float = 1e-4,
    w_res: float = 1.0,
    w_orth: float = 10.0,
    w_trace: float = 0.5,   # pulls the learned subspace to the BOTTOM of
                            # the spectrum: without it the residual loss
                            # is satisfied by ANY eigenvectors
    seed: int = 0,
    rayleigh_ritz_finish: bool = True,
    polish_iters: int = 0,
    polish_tol: float = 1e-6,
    device="cuda",
    init_params: dict | None = None,
) -> BatchedResult:
    """Jointly learn the lowest n_modes of every mesh in the family.

    `init_params` (a `StackedJointEigenNet` state_dict, e.g. the flax tree
    of `jax.vmap(JointEigenNet.init)` carried in by `from_flax_params`)
    replaces the seeded initialization. The per-mesh Rayleigh-Ritz finish
    and LOBPCG polish run on each mesh's own `as_operator` K and M; the
    polish's guard columns are drawn from a generator on `device` seeded
    with seed + 7.
    """
    device = torch.device(device)
    idx, val, mdiag, mask, X, sizes = _pack_family(K_list, M_list, X_list,
                                                   device=device)
    F, N, _ = idx.shape
    idx_t, val_t = (torch.as_tensor(a, device=device) for a in _pack_ell(
        [K.T for K in K_list], N))
    k = n_modes

    model = StackedJointEigenNet(F, X.shape[2], tuple(hidden), k).to(device)
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        model.reset_parameters(torch.Generator(device).manual_seed(seed))
    params = list(model.parameters())
    opt, _ = adam_exp_decay(params, lr_start, lr_end, epochs)
    eye = torch.eye(k, device=device)

    def step(epoch: int):
        # Padded rows are masked out of U: they add nothing to the
        # residual, the Rayleigh quotients or the Gram.
        U = model(X) * mask[..., None]
        Ku = _FamilySpmm.apply(U, idx, val, idx_t, val_t)
        Mu = mdiag[..., None] * U
        lam = (U * Ku).sum(1) / ((U * Mu).sum(1) + 1e-12)
        res = ((Ku - Mu * lam[:, None, :]) ** 2).mean(dim=(1, 2))
        G = torch.bmm(U.transpose(1, 2), Mu)
        orth = ((G - eye) ** 2).sum(dim=(1, 2)) / k
        per_mesh = w_res * res + w_orth * orth + w_trace * lam.mean(1)
        total = per_mesh.sum()
        for p in params:
            p.grad = None
        total.backward()
        opt.step()
        return {"loss": total.detach(),
                "loss_max_mesh": per_mesh.detach().max()}

    result = run_chunked_loop(step, n_epochs=epochs, chunk=scan_chunk,
                              device=device)

    with torch.no_grad():
        U = model(X)                                  # (F, N, k)
        lam_out = torch.zeros((F, k), dtype=torch.float64)
        for f in range(F):
            n = sizes[f]
            if not (rayleigh_ritz_finish or polish_iters):
                continue
            K_op = as_operator(K_list[f], device=device)
            M_op = as_operator(M_list[f], device=device)
            if rayleigh_ritz_finish:
                w, Uf = rayleigh_ritz_robust(U[f, :n], K_op, M_op)
                lam_out[f] = w[:k].double().cpu()
                U[f, :n] = Uf[:, :k]
            if polish_iters:
                # Per-mesh LOBPCG polish from the learned subspace and
                # guard columns, the single-mesh drivers' solver-grade
                # finish.
                guards = torch.randn(
                    (n, POLISH_GUARD), device=device,
                    generator=torch.Generator(device).manual_seed(seed + 7))
                X0 = torch.cat([U[f, :n], guards], dim=1)
                res = lobpcg(K_op, M_op, X0, k=k + POLISH_GUARD,
                             max_iter=polish_iters, tol=polish_tol)
                lam_out[f] = res.eigenvalues[:k].double().cpu()
                U[f, :n] = res.eigenvectors[:, :k]
    return BatchedResult(lam_out.numpy(), U.cpu().numpy(), sizes,
                         result.history, result.chunk_times)
