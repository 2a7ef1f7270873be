"""Node-minibatched `train_joint(batch_nodes=)` against the JAX trainer.

On the sphere problem of tests/test_direct_deflation.py (300 points, 15
neighbors, ELL K, Diagonal M), 4 modes, a 64 x 64 MLP, penalty mode with
w_orth 10 and 64 rows a step:

  * from the flax parameters of `JointEigenNet.init(PRNGKey(0), X)` and
    the rows JAX draws (`randint(fold_in(PRNGKey(seed + 13), epoch))`,
    fed to the port through `batch_rows`), the loss history and its
    terms over 200 epochs and the final eigenvalues match to rel 1e-4
    (fp32 sums in another order through 200 Adam steps);
  * with the port's own initialization and rows, 4000 epochs meet the
    JAX test's bar: modes 1-2 within 0.15 of eigsh
    (tests/test_direct_deflation.py::test_train_joint_minibatched);
  * whiten mode with batch_nodes raises ValueError, a `RollingBanded`
    operator TypeError, both as in the JAX trainer.

At the widths of `chip_smoke.py`'s 1M run (20 modes, 3 x 256, w_orth
1000, w_trace 0.05, 150 epochs, 1/16 of the nodes a step, the
Rayleigh-Ritz finish) on a 20k-point `make_cloud`, from JAX's parameters
and rows, in fp32 ('highest', fp32 MLP) and in the 1M run's bf16:

  * the loss history matches JAX's to rel 1e-4 in fp32 and 1e-2 in bf16
    (XLA and torch round bf16 products differently);
  * the finish's max rel error of modes 1+ against eigsh matches JAX's
    to rel 1e-2 in fp32, and within a factor of 2 in bf16, where the
    MLP's bf16 rounding of U dominates it in both packages (~0.7 in fp32
    against ~10-20 in bf16 at this size);
  * the finish's M-orthonormality defect |U^T M U - I| is fp32 round-off
    through the whitening of an ill-conditioned Gram (JAX's ~3e-4 to
    9e-4 here; the port's moves by 1.3x with the thread count alone): it
    stays within a factor of 3 of JAX's;
  * its Ritz values are ascending, none falls below eigsh's (the Ritz
    bound, to 1e-4 of the largest), and each equals its vector's
    Rayleigh quotient in fp64 to rel 1e-2 of the largest.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu.models import JointEigenNet as JJointEigenNet
from eigenpinns_tpu.solvers.direct import train_joint as j_train_joint
from eigenpinns_tpu.sparse import as_operator as j_as_operator
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.models import JointEigenNet, from_flax_params
from eigenpinns_torch.solvers import eigsh_smallest, train_joint
from eigenpinns_torch.sparse import (
    Diagonal,
    RollingBanded,
    SparseELL,
    as_operator,
)
from eigenpinns_torch.utils.fixtures import make_cloud

torch.set_num_threads(2)

KW = dict(n_modes=4, hidden=(64, 64), mode="penalty", w_res=1.0,
          w_orth=10.0, lr_start=5e-3, lr_end=1e-4, seed=0, batch_nodes=64)


# chip_smoke.py's MB_CFG (its DIRECT_CFG at 150 epochs, the finish on),
# at 1/16 of a 20k-point cloud's nodes a step.
FINISH_N = 20_000
FINISH = dict(n_modes=20, hidden=(256, 256, 256), mode="penalty",
              epochs=150, scan_chunk=50, w_res=1.0, w_orth=1000.0,
              w_trace=0.05, lr_start=2e-3, lr_end=2e-4, seed=0,
              rayleigh_ritz_finish=True, batch_nodes=FINISH_N // 16)
FINISH_DTYPES = {"fp32": dict(loss_mxu_precision="highest",
                              mlp_compute_dtype=None),
                 "bf16": dict(loss_mxu_precision="bf16",
                              mlp_compute_dtype="bfloat16")}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def sphere():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    vals = eigsh_smallest(L, M, 6)[0]
    return X, L, M, vals


def jax_rows(seed, epochs, batch, n):
    """The rows the JAX trainer draws at each epoch."""
    base = jax.random.PRNGKey(seed + 13)
    return np.stack([np.asarray(jax.random.randint(
        jax.random.fold_in(base, e), (batch,), 0, n)) for e in range(epochs)])


def test_minibatched_train_joint_matches_jax(sphere):
    X, L, M, _ = sphere
    kw = dict(KW, epochs=200, scan_chunk=50)
    jres = j_train_joint(j_as_operator(L), j_as_operator(M), X, **kw)
    jp = JJointEigenNet(kw["hidden"], kw["n_modes"]).init(
        jax.random.PRNGKey(kw["seed"]), jnp.asarray(X, jnp.float32))
    net = from_flax_params(JointEigenNet(3, kw["hidden"], kw["n_modes"]),
                           jax.tree_util.tree_map(np.asarray, jp))
    rows = jax_rows(kw["seed"], 200, kw["batch_nodes"], X.shape[0])
    res = train_joint(as_operator(L, device="cpu"),
                      as_operator(M, device="cpu"), X,
                      init_params=net.state_dict(), batch_rows=rows, **kw)
    assert res.epochs_run == jres.epochs_run == 200
    for key in ("loss", "res", "orth", "lam_mean"):
        assert _rel(res.history[key], jres.history[key]) < 1e-4, key
    assert _rel(res.eigenvalues, jres.eigenvalues) < 1e-4


def test_minibatched_train_joint_meets_the_jax_bar(sphere):
    X, L, M, vals = sphere
    res = train_joint(as_operator(L, device="cpu"),
                      as_operator(M, device="cpu"), X, epochs=4000, **KW)
    rel = np.abs(res.eigenvalues[1:3] - vals[1:3]) / vals[1:3]
    assert rel.max() < 0.15, (res.eigenvalues, vals)
    assert np.isfinite(res.eigenvectors).all()


def test_minibatched_train_joint_rejects(sphere):
    X, L, M, _ = sphere
    K, Mop = as_operator(L, device="cpu"), as_operator(M, device="cpu")
    with pytest.raises(ValueError, match="penalty"):
        train_joint(K, Mop, X, 3, mode="whiten", batch_nodes=8, epochs=1)
    rolling, _ = RollingBanded.from_scipy(L, reorder=False, device="cpu")
    with pytest.raises(TypeError, match="Diagonal/SparseELL"):
        train_joint(rolling, Mop, X, 3, batch_nodes=8, epochs=1)
    for shape in ((1, 4), (1, 8)):      # too narrow; too few epochs
        with pytest.raises(ValueError, match="batch_rows"):
            train_joint(K, Mop, X, 3, batch_nodes=8, epochs=2,
                        batch_rows=np.zeros(shape, np.int64))


@pytest.fixture(scope="module")
def cloud_20k():
    X = make_cloud(FINISH_N, seed=0)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    return X, L, np.asarray(M.diagonal()), eigsh_smallest(L, M, 20)[0]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_minibatched_rayleigh_ritz_finish_matches_jax(cloud_20k, dtype):
    X, L, m, vals = cloud_20k
    kw = dict(FINISH, **FINISH_DTYPES[dtype])
    jres = j_train_joint(j_as_operator(L), j_as_operator(sp.diags(m)), X,
                         **kw)
    jp = JJointEigenNet(kw["hidden"], kw["n_modes"]).init(
        jax.random.PRNGKey(kw["seed"]), jnp.asarray(X, jnp.float32))
    net = from_flax_params(JointEigenNet(3, kw["hidden"], kw["n_modes"]),
                           jax.tree_util.tree_map(np.asarray, jp))
    rows = jax_rows(kw["seed"], kw["epochs"], kw["batch_nodes"], len(X))
    res = train_joint(SparseELL.from_scipy(L, device="cpu"),
                      Diagonal(torch.as_tensor(m, dtype=torch.float32)), X,
                      device="cpu", init_params=net.state_dict(),
                      batch_rows=rows, **kw)

    def finish(r):
        U = np.asarray(r.eigenvectors, np.float64)
        lam = np.asarray(r.eigenvalues, np.float64)
        err = (np.abs(lam[1:] - vals[1:]) / vals[1:]).max()
        defect = np.abs(U.T @ (m[:, None] * U) - np.eye(U.shape[1])).max()
        rq = np.sum(U * (L @ U), 0) / np.sum(U * (m[:, None] * U), 0)
        return lam, err, defect, rq

    lam, err, defect, rq = finish(res)
    _, jerr, jdefect, _ = finish(jres)
    loss_tol = 1e-4 if dtype == "fp32" else 1e-2
    assert _rel(res.history["loss"], jres.history["loss"]) < loss_tol
    if dtype == "fp32":
        assert abs(err - jerr) / jerr < 1e-2, (err, jerr)
    else:
        assert 0.5 < err / jerr < 2.0, (err, jerr)
    assert defect < 3.0 * jdefect, (defect, jdefect)
    assert np.all(np.diff(lam) >= 0)
    assert (lam - vals).min() >= -1e-4 * np.abs(vals).max()
    assert np.abs(rq - lam).max() < 1e-2 * np.abs(lam).max()
