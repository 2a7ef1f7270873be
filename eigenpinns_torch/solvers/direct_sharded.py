"""Node-sharded direct joint eigen-learning — the distributed trainer.

Port of `eigenpinns_tpu/solvers/direct_sharded.py`: the single-device
`train_joint` (solvers/direct.py) scaled by N across ranks. Collocation
points, eigenvector blocks and the sparse operators are row-sharded over
the mesh's data axis; model parameters are replicated. Every training
step, on every rank:

  * the model forward runs on this rank's rows;
  * K U / M U ride the halo-banded sharded SpMM (two (B, k) ring
    messages + the shard block through K4, `parallel/sharded_banded.py`),
    with the cluster-split all-gathered remainder at 1M-cloud scale;
  * every k x k reduction (Rayleigh numerators and denominators, the
    M-Gram) is a local partial + `psum` over the data axis, two
    all-reduces a step;
  * the gradients of the replicated parameters are averaged over the
    data axis in one all-reduce (`parallel/sharded.py` says why the mean
    gives the single-device gradient).

Called on every rank of an initialized `torch.distributed` group with
the same host inputs; every rank returns the same result, eigenvectors
in the caller's vertex order. Semantics match `train_joint(mode=
'penalty')`. Checkpoints hold the replicated parameters and the Adam
state, so they do not depend on the mesh's shape: rank 0 writes, every
rank restores.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import scipy.sparse as sp
import torch
import torch.distributed as dist

from eigenpinns_torch.models.eigennet import JointEigenNet
from eigenpinns_torch.parallel.mesh import Mesh, make_mesh, shard_array
from eigenpinns_torch.parallel.sharded import (
    average_gradients,
    broadcast_,
    gather_rows,
    psum,
)
from eigenpinns_torch.parallel.sharded_banded import (
    ShardedBanded,
    ShardedRemainder,
    _split_decompose,
    build_sharded_operator,
    sharded_banded_spmm,
    sharded_split_spmm,
)
from eigenpinns_torch.solvers.rayleigh_ritz import eigh_generalized
from eigenpinns_torch.train.checkpoint import TrainCheckpointer
from eigenpinns_torch.train.loop import module_state_fns, run_chunked_loop
from eigenpinns_torch.train.optim import adam_exp_decay


@dataclasses.dataclass
class ShardedDirectResult:
    eigenvalues: np.ndarray
    eigenvectors: np.ndarray      # (n, k) in the CALLER's vertex order
    history: dict
    epochs_run: int
    wall_time: float
    chunk_times: list
    perm: np.ndarray              # internal ordering (diagnostic)
    steady_steps_per_sec: float | None = None  # timing_chunks probe


@dataclasses.dataclass
class ShardedProblem:
    """Host-side preprocessing product: operators sharded and ordered.
    `spmm_K` / `spmm_M` map this rank's rows to this rank's rows."""

    spmm_K: Any
    spmm_M: Any
    m_diag: Any                   # (per,) this rank's mass diagonal | None
    mesh: Mesh
    perm: np.ndarray
    n: int
    n_pad: int
    per: int
    kind: str                     # 'banded' | 'split'
    core: ShardedBanded           # K's banded core (this rank's block)


def _is_diagonal(M) -> bool:
    M = M.tocsr()
    return (M - sp.diags(M.diagonal())).nnz == 0


def resolve_mesh(mesh, n_devices, device="cuda",
                 axis: str = "data") -> Mesh:
    """The mesh a sharded entry point runs on: `mesh`, or a 1-axis mesh
    over the initialized group on `device`'s type; `n_devices`, when
    given, must equal the data axis's size."""
    if mesh is None:
        mesh = make_mesh(n_devices, device_type=torch.device(device).type)
    elif not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be a parallel.Mesh, got {type(mesh)}")
    if n_devices is not None and n_devices != mesh.axis_size(axis):
        raise ValueError(f"n_devices {n_devices} != the data axis's size "
                         f"{mesh.axis_size(axis)}")
    return mesh


def prepare_sharded_problem(K, M, X=None, mesh=None, n_devices=None,
                            dtype=torch.float32, tile: int = 128,
                            max_bandwidth: int = 4096,
                            window: int = 1024,
                            device="cuda") -> ShardedProblem:
    """Order + shard K and M consistently for the mesh's data axis.

    K picks the ordering (RCM if its stencil fits a one-neighbor halo,
    spatial cluster order otherwise); M reuses it so node data lives in
    ONE layout. Diagonal (lumped) mass stays a sharded vector. Each rank
    builds its own shard's blocks, on the mesh's device (`device` makes
    the mesh when none is given)."""
    mesh = resolve_mesh(mesh, n_devices, device)
    n_dev, me, dev = mesh.axis_size("data"), mesh.axis_index("data"), \
        mesh.device
    kind, (coreK, remK), perm = build_sharded_operator(
        K, n_dev, X=X, dtype=dtype, tile=tile,
        max_bandwidth=max_bandwidth, window=window, shards=(me,),
        device=dev)
    spmm_K = (sharded_banded_spmm(coreK, mesh) if kind == "banded"
              else sharded_split_spmm(coreK, remK, mesh))
    n, n_pad, per = coreK.n, coreK.n_pad, coreK.per

    m_diag = None
    Mp = M.tocsr()[perm][:, perm].tocsr()
    if _is_diagonal(M):
        d = np.zeros(n_pad, dtype=np.float32)
        d[:n] = Mp.diagonal()
        m_diag = shard_array(d, mesh, "data")

        def spmm_M(u, _d=m_diag):
            return _d[:, None] * u
    elif kind == "banded":
        coreM, _ = ShardedBanded.from_scipy(
            Mp, n_dev, dtype=dtype, tile=tile, reorder=False,
            max_bandwidth=max_bandwidth, shards=(me,), device=dev)
        spmm_M = sharded_banded_spmm(coreM, mesh)
    else:
        core_sp, rem_sp = _split_decompose(Mp, tile, window)
        coreM, _ = ShardedBanded.from_scipy(
            core_sp, n_dev, dtype=dtype, tile=tile, reorder=False,
            max_bandwidth=max_bandwidth, shards=(me,), device=dev)
        remM = (ShardedRemainder.from_scipy(rem_sp, n_dev, per)
                if rem_sp.nnz else None)
        spmm_M = sharded_split_spmm(coreM, remM, mesh)

    return ShardedProblem(spmm_K=spmm_K, spmm_M=spmm_M, m_diag=m_diag,
                          mesh=mesh, perm=perm, n=n, n_pad=n_pad, per=per,
                          kind=kind, core=coreK)


def to_caller_order(U_local: torch.Tensor, prob: ShardedProblem,
                    ) -> np.ndarray:
    """Every rank's rows of U, unpadded, in the caller's vertex order."""
    U = gather_rows(U_local, prob.mesh, prob.n).cpu().numpy()
    out = np.empty_like(U)
    out[prob.perm] = U
    return out


def train_joint_sharded(
    K,
    M,
    X,
    n_modes: int,
    mesh=None,
    n_devices: int | None = None,
    hidden=(64, 64, 64),
    activation: str = "silu",
    epochs: int = 5000,
    scan_chunk: int = 200,
    lr_start: float = 1e-2,
    lr_end: float = 1e-4,
    w_res: float = 1.0,
    w_orth: float = 1.0,
    w_trace: float = 0.0,
    max_bandwidth: int = 4096,
    window: int = 1024,
    seed: int = 0,
    rayleigh_ritz_finish: bool = True,
    mlp_compute_dtype: str | None = None,
    timing_chunks: int = 0,
    problem: ShardedProblem | None = None,
    checkpoint_dir: str = "",
    checkpoint_every_chunks: int = 10,
    log_fn=None,
    log_every: int = 0,
    init_params: dict | None = None,
    device="cuda",
) -> ShardedDirectResult:
    """Distributed `train_joint(mode='penalty')`: same math, N sharded.

    K, M: scipy sparse (symmetric); X: (n, d) coordinates in the SAME
    row order. Pass a prebuilt `problem` to reuse preprocessing.
    `init_params` (a state_dict of `JointEigenNet`, e.g. flax parameters
    through `models.from_flax_params`) replaces the seeded
    initialization (a generator seeded with `seed`); either way rank 0's
    parameters are broadcast over the data axis. Without `mesh` the
    mesh is made over the initialized group on `device` ('cuda': each
    rank's current card; 'cpu').
    """
    prob = problem if problem is not None else prepare_sharded_problem(
        K, M, X=X, mesh=mesh, n_devices=n_devices,
        max_bandwidth=max_bandwidth, window=window, device=device)
    mesh = prob.mesh
    dev = mesh.device
    n, n_pad, perm = prob.n, prob.n_pad, prob.perm
    k = n_modes

    X_p = np.zeros((n_pad, np.shape(X)[1]), dtype=np.float32)
    X_p[:n] = np.asarray(X, dtype=np.float32)[perm]
    mask_p = np.zeros((n_pad, 1), dtype=np.float32)
    mask_p[:n] = 1.0
    X_l = shard_array(X_p, mesh, "data")
    mask_l = shard_array(mask_p, mesh, "data")

    model = JointEigenNet(X_p.shape[1], tuple(hidden), n_modes,
                          activation=activation,
                          compute_dtype=mlp_compute_dtype).to(dev)
    if init_params is not None:
        model.load_state_dict(init_params)
    else:
        model.reset_parameters(torch.Generator(dev).manual_seed(seed))
    params = list(model.parameters())
    broadcast_(params, mesh)
    opt, _ = adam_exp_decay(params, lr_start, lr_end, epochs)
    eye = torch.eye(k, device=dev)

    def predict():
        return model(X_l) * mask_l          # zero padded rows everywhere

    def loss_fn():
        U = predict()
        Ku = prob.spmm_K(U)
        Mu = prob.spmm_M(U)
        # The sums over the sharded node axis: local partials + psum,
        # the three of them in one all-reduce.
        s = psum(torch.cat([(U * Ku).sum(0), (U * Mu).sum(0),
                            (U.T @ Mu).reshape(-1)]), mesh)
        lam = s[:k] / (s[k:2 * k] + 1e-12)
        G = s[2 * k:].view(k, k)
        res = psum(((Ku - Mu * lam[None, :]) ** 2).sum(), mesh) / (n * k)
        orth = ((G - eye) ** 2).sum() / k
        total = w_res * res + w_orth * orth
        if w_trace:
            total = total + w_trace * lam.mean()
        return total, {"loss": total, "res": res, "orth": orth,
                       "lam_mean": lam.mean()}

    def step(epoch: int):
        for p in params:
            p.grad = None
        total, metrics = loss_fn()
        total.backward()
        average_gradients(params, mesh)
        opt.step()
        return metrics

    def train_state():
        return {"params": [p.detach() for p in params],
                "opt": opt.state_dict()}

    # Checkpoint/resume: parameters + Adam state, replicated, so the
    # checkpoint does not depend on the mesh's shape; schedules continue
    # from the restored epoch.
    ckptr, epoch0 = None, 0
    rank0 = dist.get_rank() == 0
    if checkpoint_dir:
        ckptr = TrainCheckpointer(checkpoint_dir)
        prev_step, prev = ckptr.restore_latest(target=train_state())
        if prev is not None:
            with torch.no_grad():
                for p, v in zip(params, prev["params"]):
                    p.copy_(v)
            opt.load_state_dict(prev["opt"])
            epoch0 = int(prev_step)

    def save(step_no):
        if rank0:
            ckptr.save(step_no, train_state())
        dist.barrier()

    chunk_cb = None
    if ckptr is not None and checkpoint_every_chunks:
        n_chunks_seen = [0]

        def chunk_cb(epochs_run):
            n_chunks_seen[0] += 1
            if n_chunks_seen[0] % checkpoint_every_chunks == 0:
                save(epoch0 + epochs_run)

    result = run_chunked_loop(step, n_epochs=epochs, chunk=scan_chunk,
                              log_every=log_every, log_fn=log_fn,
                              device=dev, start_epoch=epoch0,
                              chunk_callback=chunk_cb,
                              timing_chunks=timing_chunks,
                              state_fns=module_state_fns(params, opt))
    if ckptr is not None:
        save(epoch0 + result.epochs_run)

    # Finish: Rayleigh-Ritz in the learned subspace, every reduction
    # psum'd, only the k x k solve dense (alike on every rank).
    with torch.no_grad():
        U = predict()
        Ku, Mu = prob.spmm_K(U), prob.spmm_M(U)
        if rayleigh_ritz_finish:
            A = psum(U.T @ Ku, mesh)
            B = psum(U.T @ Mu, mesh)
            w, C = eigh_generalized(0.5 * (A + A.T), 0.5 * (B + B.T),
                                    jitter=1e-9)
            lam, U = w[:k], U @ C[:, :k]
        else:
            s = psum(torch.cat([(U * Ku).sum(0), (U * Mu).sum(0)]), mesh)
            lam = s[:k] / (s[k:] + 1e-12)
    return ShardedDirectResult(
        eigenvalues=lam.cpu().numpy(),
        eigenvectors=to_caller_order(U, prob),
        history=result.history,
        epochs_run=result.epochs_run,
        wall_time=result.wall_time,
        chunk_times=result.chunk_times,
        perm=perm,
        steady_steps_per_sec=result.steady_rate,
    )
