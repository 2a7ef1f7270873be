"""Parity of the port's mesh-family trainer with JAX.

Three small sphere clouds of different sizes and radii (the family of
`tests/test_direct_deflation.py::test_train_joint_family_batched`), their
point-cloud Laplacians from the port's numpy host code handed to both
packages, and the per-mesh flax parameters of `jax.vmap(model.init)`
carried into the port's `StackedJointEigenNet`. Tolerances:

  * `StackedJointEigenNet` against `jax.vmap(JointEigenNet.apply)`:
    forward and parameter gradients rel 1e-5;
  * `_pack_family`: equal arrays;
  * `train_joint_family`: the loss and worst-mesh loss histories epoch by
    epoch rel 1e-4 (fp32 sums in another order through 60 Adam steps on
    an exponentially decaying rate), the Rayleigh-Ritz eigenvalues rel
    1e-4, and after a 150-iteration per-mesh LOBPCG polish (the port's
    block carries 8 guard columns, ROADMAP F19; the JAX driver's none:
    both converge here) the eigenvalues rel 1e-5 and each against the
    mesh's own eigsh to rel 1e-4.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenpinns_tpu.models import JointEigenNet as JJointEigenNet
from eigenpinns_tpu.solvers import batched as j_batched
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.models import StackedJointEigenNet, from_flax_params
from eigenpinns_torch.solvers import (
    eigsh_smallest,
    hierarchical_eigensolve,
    solve_deflation,
    solve_deflation_adaptive,
    train_joint_family,
)
from eigenpinns_torch.solvers.batched import (
    _FamilySpmm,
    _family_gather,
    _pack_ell,
    _pack_family,
)

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)

HIDDEN, K_MODES = (24, 24), 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


@pytest.fixture(scope="module")
def family():
    K_list, M_list, X_list = [], [], []
    for f in range(3):
        X = np.random.default_rng(10 + f).normal(size=(150 + 20 * f, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        X *= 1.0 + 0.2 * f
        L, M = point_cloud_laplacian(X, n_neighbors=12)
        K_list.append(L)
        M_list.append(M)
        X_list.append(X)
    return K_list, M_list, X_list


def _stacked_flax(X_packed, seed=0):
    """The JAX driver's initialization: vmap(model.init) over
    split(PRNGKey(seed), F), as numpy leaves."""
    model = JJointEigenNet(HIDDEN, K_MODES)
    keys = jax.random.split(jax.random.PRNGKey(seed), X_packed.shape[0])
    tree = jax.vmap(model.init)(keys, jnp.asarray(X_packed))
    return model, tree, jax.tree_util.tree_map(np.asarray, tree)


def test_pack_family_matches_jax(family):
    j_out = j_batched._pack_family(*family)
    t_out = _pack_family(*family, device="cpu")
    assert j_out[-1] == t_out[-1]
    for a, b in zip(t_out[:-1], j_out[:-1]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_family_spmm_backward_gathers_the_transpose():
    """The padded-ELL product's custom backward (a gather on the stored
    transposes) equals autograd's scatter-add, on nonsymmetric members
    of different sizes."""
    import scipy.sparse as sp

    mats = [sp.random(n, n, density=0.05, random_state=s, format="csr")
            for s, n in ((0, 40), (1, 31))]
    idx, val = (torch.as_tensor(a) for a in _pack_ell(mats, 40))
    idx_t, val_t = (torch.as_tensor(a) for a in _pack_ell(
        [A.T for A in mats], 40))
    U = torch.randn(2, 40, 3, dtype=torch.float32)
    U[1, 31:] = 0.0
    g = torch.randn(2, 40, 3)
    Ua = U.clone().requires_grad_(True)
    (_FamilySpmm.apply(Ua, idx, val, idx_t, val_t) * g).sum().backward()
    Ub = U.clone().requires_grad_(True)
    (_family_gather(idx, val, Ub) * g).sum().backward()
    assert _rel(Ua.grad[0].numpy(), Ub.grad[0].numpy()) < 1e-6
    assert _rel(Ua.grad[1, :31].numpy(), Ub.grad[1, :31].numpy()) < 1e-6
    dense = np.stack([np.pad(A.toarray(), ((0, 40 - A.shape[0]),) * 2)
                      for A in mats]).astype(np.float32)
    ref = np.einsum("fnm,fmk->fnk", dense, U.numpy())
    assert _rel(_family_gather(idx, val, U).numpy(), ref) < 1e-6


def test_stacked_net_matches_vmapped_flax(family):
    X = np.asarray(j_batched._pack_family(*family)[4])
    model, tree, np_tree = _stacked_flax(X)

    def f(p):
        U = jax.vmap(model.apply)(p, jnp.asarray(X))
        return jnp.sum(jnp.sin(U))

    grads = jax.grad(f)(tree)["params"]["MLP_0"]
    net = StackedJointEigenNet(3, 3, HIDDEN, K_MODES)
    from_flax_params(net, np_tree)
    U = net(torch.from_numpy(np.array(X)))
    torch.sin(U).sum().backward()
    assert _rel(U.detach().numpy(),
                jax.vmap(model.apply)(tree, jnp.asarray(X))) < 1e-5
    names = [f"hidden_{i}" for i in range(len(HIDDEN))] + ["out"]
    for w, b, name in zip(net.kernels, net.biases, names):
        assert _rel(w.grad.numpy(), grads[name]["kernel"]) < 1e-5
        assert _rel(b.grad.numpy(), grads[name]["bias"]) < 1e-5


def test_train_joint_family_matches_jax(family):
    kw = dict(n_modes=K_MODES, hidden=HIDDEN, epochs=60, scan_chunk=30,
              seed=0, polish_iters=150)
    jr = j_batched.train_joint_family(*family, **kw)
    X = np.asarray(j_batched._pack_family(*family)[4])
    _, _, np_tree = _stacked_flax(X)
    net = StackedJointEigenNet(3, 3, HIDDEN, K_MODES)
    from_flax_params(net, np_tree)
    tr = train_joint_family(*family, device="cpu",
                            init_params=net.state_dict(), **kw)
    assert tr.sizes == jr.sizes
    for key in ("loss", "loss_max_mesh"):
        assert _rel(tr.history[key], jr.history[key]) < 1e-4, key
    assert tr.eigenvalues.shape == (3, K_MODES)
    for f, (K, M, _) in enumerate(zip(*family)):
        assert _rel(tr.eigenvalues[f], jr.eigenvalues[f]) < 1e-5, f
        vals = eigsh_smallest(K, M, K_MODES)[0]
        assert _rel(tr.eigenvalues[f], vals) < 1e-4, f
    rr = train_joint_family(*family, device="cpu",
                            init_params=net.state_dict(),
                            **dict(kw, polish_iters=0))
    jrr = j_batched.train_joint_family(*family, **dict(kw, polish_iters=0))
    assert _rel(rr.eigenvalues, jrr.eigenvalues) < 1e-4


def test_solver_family_runs_on_the_card_by_default():
    """The drivers that build their own operators from scipy matrices
    default to the card; the deflation drivers run on their operators'
    device, `train_per_level` on its hierarchy's and the Dirichlet CG on
    its operator's, all of which default to the card."""
    for fn in (train_joint_family, hierarchical_eigensolve):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    for fn in (solve_deflation, solve_deflation_adaptive):
        assert "device" not in inspect.signature(fn).parameters
