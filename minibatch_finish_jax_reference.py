#!/usr/bin/env python3
"""The Rayleigh-Ritz finish of node-minibatched `train_joint`, both
packages, on the CPU.

    python3 minibatch_finish_jax_reference.py   (~2 min on 8 cores)

At the widths of `chip_smoke.py`'s 1M minibatched run (20 modes,
3 x 256, w_orth 1000, w_trace 0.05, 150 epochs, 1/16 of the nodes a
step, the finish on) on a 20k-point `make_cloud` (15 neighbors), from
JAX's flax parameters and the rows JAX draws, in fp32 ('highest', fp32
MLP) and in the 1M run's bf16. For each it prints, per package: the
finish's max rel error of modes 1+ against eigsh, its |U^T M U - I|,
how far its Ritz values fall below eigsh's at most and part from their
vectors' fp64 Rayleigh quotients (both relative to the largest); and
the loss histories' rel distance. `tests/test_torch_minibatch.py::
test_minibatched_rayleigh_ritz_finish_matches_jax` holds these.
"""

import jax
import jax.numpy as jnp
import numpy as np
import scipy.sparse as sp
import torch

jax.config.update("jax_platforms", "cpu")

from eigenpinns_tpu.models import JointEigenNet as JJointEigenNet  # noqa: E402,E501
from eigenpinns_tpu.solvers.direct import train_joint as j_train_joint  # noqa: E402,E501
from eigenpinns_tpu.sparse import as_operator as j_as_operator  # noqa: E402
from eigenpinns_torch.geometry import point_cloud_laplacian  # noqa: E402
from eigenpinns_torch.models import JointEigenNet, from_flax_params  # noqa: E402,E501
from eigenpinns_torch.solvers import eigsh_smallest, train_joint  # noqa: E402
from eigenpinns_torch.sparse import Diagonal, SparseELL  # noqa: E402
from eigenpinns_torch.utils.fixtures import make_cloud  # noqa: E402

N = 20_000
CFG = dict(n_modes=20, hidden=(256, 256, 256), mode="penalty", epochs=150,
           scan_chunk=50, w_res=1.0, w_orth=1000.0, w_trace=0.05,
           lr_start=2e-3, lr_end=2e-4, seed=0, rayleigh_ritz_finish=True,
           batch_nodes=N // 16)
DTYPES = {"fp32": dict(loss_mxu_precision="highest", mlp_compute_dtype=None),
          "bf16": dict(loss_mxu_precision="bf16",
                       mlp_compute_dtype="bfloat16")}


def main():
    torch.set_num_threads(2)
    X = make_cloud(N, seed=0)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    m = np.asarray(M.diagonal())
    vals = eigsh_smallest(L, M, 20)[0]
    base = jax.random.PRNGKey(CFG["seed"] + 13)
    rows = np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(base, e), (CFG["batch_nodes"],), 0, N))
        for e in range(CFG["epochs"])])
    jp = JJointEigenNet(CFG["hidden"], 20).init(
        jax.random.PRNGKey(CFG["seed"]), jnp.asarray(X, jnp.float32))
    init = from_flax_params(JointEigenNet(3, CFG["hidden"], 20),
                            jax.tree_util.tree_map(np.asarray, jp))
    for name, dt in DTYPES.items():
        kw = dict(CFG, **dt)
        runs = {
            "jax": j_train_joint(j_as_operator(L),
                                 j_as_operator(sp.diags(m)), X, **kw),
            "torch": train_joint(
                SparseELL.from_scipy(L, device="cpu"),
                Diagonal(torch.as_tensor(m, dtype=torch.float32)), X,
                device="cpu", init_params=init.state_dict(),
                batch_rows=rows, **kw)}
        for pkg, r in runs.items():
            U = np.asarray(r.eigenvectors, np.float64)
            lam = np.asarray(r.eigenvalues, np.float64)
            rq = np.sum(U * (L @ U), 0) / np.sum(U * (m[:, None] * U), 0)
            err = (np.abs(lam[1:] - vals[1:]) / vals[1:]).max()
            defect = np.abs(U.T @ (m[:, None] * U) - np.eye(20)).max()
            below = ((vals - lam) / np.abs(vals).max()).max()
            rq_dev = (np.abs(rq - lam) / np.abs(lam).max()).max()
            print(f"{name} {pkg}: max rel err of modes 1+ {float(err)!r}, "
                  f"|U^T M U - I| {float(defect)!r}, most below eigsh "
                  f"{float(below)!r}, Ritz value vs Rayleigh quotient "
                  f"{float(rq_dev)!r}", flush=True)
        lj = np.asarray(runs["jax"].history["loss"], np.float64)
        lt = np.asarray(runs["torch"].history["loss"], np.float64)
        rel = (np.abs(lt - lj) / np.abs(lj)).max()
        print(f"{name}: loss history rel {float(rel)!r}", flush=True)


if __name__ == "__main__":
    main()
