"""Parity of the port's direct joint trainer and its parts with JAX.

The same numpy inputs and flax parameters go through both packages.
Tolerances:

  * `JointEigenNet` / `MLP`: forward and parameter gradients rel 1e-5
    in fp32, for every activation (bf16 compute is not compared here:
    flax and torch round at different sites);
  * whitening, the loss terms: rel 1e-5, U-gradients rel 1e-4 (two
    products deep);
  * `adam_exp_decay`: the schedule equals optax's to rel 1e-6 (fp32
    `pow` in another library), the parameters after each update rel 1e-6;
  * `train_joint` on a 642-point cloud (strip-BSR K, Diagonal M, the
    parameters of `JointEigenNet.init(PRNGKey(seed), X)` carried in): the
    first 30 losses rel 1e-4 in 'highest' and 'high' (fp32 sums in
    another order, carried through 30 Adam steps), the final eigenvalues
    rel 1e-4. In 'bf16' the JAX reference on the CPU does not round U
    (ROADMAP F8) while the port does, so there only the loss trajectory
    and the eigenvalues are held, to rel 1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from eigenpinns_tpu import losses as jlosses
from eigenpinns_tpu.models import JointEigenNet as JJointEigenNet
from eigenpinns_tpu.models import MLP as JMLP
from eigenpinns_tpu.solvers.direct import train_joint as j_train_joint
from eigenpinns_tpu.sparse import BSRTile as JBSRTile
from eigenpinns_tpu.sparse import Diagonal as JDiagonal
from eigenpinns_tpu.train.optim import adam_exp_decay as j_adam_exp_decay
from eigenpinns_torch import losses as tlosses
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.models import MLP, JointEigenNet, from_flax_params
from eigenpinns_torch.solvers import train_joint
from eigenpinns_torch.sparse import BSRTile, Diagonal
from eigenpinns_torch.train import adam_exp_decay
from eigenpinns_torch.utils.fixtures import make_cloud

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)

ACTS = ["relu", "silu", "gelu", "tanh", "sin"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _check_net(jm, tm, x):
    xj = jnp.asarray(x)
    jp = jm.init(jax.random.PRNGKey(1), xj)
    from_flax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    out_j = np.asarray(jm.apply(jp, xj))
    grads = jax.grad(lambda p: jnp.sum(jnp.sin(jm.apply(p, xj))))(jp)
    gj = grads["params"].get("MLP_0", grads["params"])
    mlp = tm.mlp if isinstance(tm, JointEigenNet) else tm
    out_t = tm(torch.from_numpy(x))
    torch.sin(out_t).sum().backward()
    assert _rel(out_t.detach().numpy(), out_j) < 1e-5
    layers = {f"hidden_{i}": h for i, h in enumerate(mlp.hidden)}
    layers["out"] = mlp.out
    for name, layer in layers.items():
        assert _rel(layer.weight.grad.numpy().T, gj[name]["kernel"]) < 1e-5
        assert _rel(layer.bias.grad.numpy(), gj[name]["bias"]) < 1e-5


@pytest.mark.parametrize("activation", ACTS)
def test_joint_eigen_net_matches_flax(activation):
    x = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    _check_net(JJointEigenNet((16, 16), 6, activation=activation),
               JointEigenNet(3, (16, 16), 6, activation=activation), x)


def test_sin_first_layer_omega_matches_flax():
    """SIREN-style input scaling on the first hidden layer only."""
    x = np.random.default_rng(1).normal(size=(40, 3)).astype(np.float32)
    _check_net(JMLP((16, 16), 4, activation="sin", first_layer_omega=3.0),
               MLP(3, (16, 16), 4, activation="sin", first_layer_omega=3.0),
               x)


@pytest.fixture(scope="module")
def cloud():
    """A 642-point cloud on the bench's perturbed sphere, its Laplacian
    (the port's numpy host code, handed to both packages) and both
    packages' strip-BSR K, lumped M and RCM-ordered X."""
    X = make_cloud(642, seed=1)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    jK, perm = JBSRTile.from_scipy(L)
    tK, tperm = BSRTile.from_scipy(L, device="cpu")
    np.testing.assert_array_equal(perm, tperm)
    m = np.asarray(M.diagonal())[perm]
    return {"X": X[perm], "jK": jK, "tK": tK,
            "jM": JDiagonal(jnp.asarray(m, jnp.float32)),
            "tM": Diagonal(torch.as_tensor(m, dtype=torch.float32))}


def test_whitening_matches_jax(cloud):
    U = np.random.default_rng(2).normal(size=(642, 6)).astype(np.float32)
    jM, tM = cloud["jM"], cloud["tM"]
    Uj = jnp.asarray(U)
    Ut = torch.from_numpy(U).requires_grad_(True)
    pairs = [
        (tlosses.newton_schulz_orthonormalize(Ut, tM, n_iters=6),
         jlosses.newton_schulz_orthonormalize(Uj, jM, n_iters=6)),
        (tlosses.spectral_orthonormalize(Ut, tM),
         jlosses.spectral_orthonormalize(Uj, jM)),
        (tlosses.gram_condition_penalty(Ut, tM),
         jlosses.gram_condition_penalty(Uj, jM)),
    ]
    for t, j in pairs:
        assert _rel(t.detach().numpy(), j) < 1e-5
    G = np.asarray(U.T @ U, np.float32) / 642
    np.testing.assert_allclose(
        tlosses.newton_schulz_inv_sqrt(torch.from_numpy(G), 8).numpy(),
        np.asarray(jlosses.newton_schulz_inv_sqrt(jnp.asarray(G), 8)),
        rtol=1e-5, atol=1e-6)

    def jf(u):
        return (jnp.sum(jnp.sin(jlosses.newton_schulz_orthonormalize(
            u, jM, n_iters=6))) + jnp.sum(jnp.sin(
                jlosses.spectral_orthonormalize(u, jM))))

    sum(torch.sin(t).sum() for t, _ in pairs[:2]).backward()
    assert _rel(Ut.grad.numpy(), jax.grad(jf)(Uj)) < 1e-4


def test_loss_terms_match_jax(cloud):
    jK, tK, jM, tM = cloud["jK"], cloud["tK"], cloud["jM"], cloud["tM"]
    rng = np.random.default_rng(3)
    U = rng.normal(size=(642, 5)).astype(np.float32)
    Uprev = rng.normal(size=(642, 3)).astype(np.float32)
    lam = np.array([0.3, 0.1, 0.105, 2.0, 2.001], np.float32)

    def terms(mod, K, M, u, up, lam_, asarray):
        return [*mod.rayleigh_and_residual(u, K, M),
                mod.gram_orthogonality(u, M),
                mod.normalization(u[:, 0], M),
                mod.deflation(u[:, 0], M, up),
                mod.smoothness(u, K),
                mod.zero_lambda(asarray(lam_)),
                mod.diversity(asarray(lam_), 0.01)]

    Ut = torch.from_numpy(U).requires_grad_(True)
    tt = terms(tlosses, tK, tM, Ut, torch.from_numpy(Uprev), lam,
               torch.from_numpy)
    jt = terms(jlosses, jK, jM, jnp.asarray(U), jnp.asarray(Uprev), lam,
               jnp.asarray)
    for t, j in zip(tt, jt):
        assert _rel(t.detach().numpy(), j) < 1e-5
    assert float(tt[-1]) > 0   # a gap below min_gap
    gj = jax.grad(lambda u: sum(jnp.sum(v) for v in terms(
        jlosses, jK, jM, u, jnp.asarray(Uprev), lam, jnp.asarray)[:6]))(
            jnp.asarray(U))
    sum(v.sum() for v in tt[:6]).backward()
    assert _rel(Ut.grad.numpy(), gj) < 1e-4


def test_adam_exp_decay_matches_optax():
    """The learning rates of optax.exponential_decay, and the parameters
    after each optax.adam(schedule) update."""
    rng = np.random.default_rng(4)
    steps = 40
    jopt, jsched = j_adam_exp_decay(2e-3, 2e-4, steps)
    p0 = rng.normal(size=(5, 3)).astype(np.float32)
    tp = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    topt, tsched = adam_exp_decay([tp], 2e-3, 2e-4, steps)
    lr_j = np.array([float(jsched(jnp.asarray(t, jnp.int32)))
                     for t in range(steps + 3)], np.float64)
    lr_t = np.array([tsched(t) for t in range(steps + 3)], np.float64)
    np.testing.assert_allclose(lr_t, lr_j, rtol=1e-6)
    assert lr_t[0] == np.float32(2e-3)
    np.testing.assert_allclose(lr_t[steps], 2e-4, rtol=1e-6)
    jp = jnp.asarray(p0)
    state = jopt.init(jp)
    for _ in range(10):
        g = rng.normal(size=p0.shape).astype(np.float32)
        upd, state = jopt.update(jnp.asarray(g), state)
        jp = optax.apply_updates(jp, upd)
        tp.grad = torch.from_numpy(g)
        topt.step()
        assert _rel(tp.detach().numpy(), jp) < 1e-6


TRAIN = dict(n_modes=5, hidden=(32, 32), epochs=30, scan_chunk=15,
             w_res=1.0, w_orth=10.0, w_trace=0.05, w_order=0.1, w_zero=0.1,
             w_zero_mean=0.1, w_diversity=0.1, lr_start=1e-2, lr_end=1e-3,
             seed=0)


@pytest.mark.parametrize("mode,precision,finish", [
    ("penalty", "highest", True), ("penalty", "high", False),
    ("whiten", "highest", True), ("whiten", "high", True),
    ("penalty", "bf16", True)])
def test_train_joint_matches_jax(cloud, mode, precision, finish):
    kw = dict(TRAIN, mode=mode, loss_mxu_precision=precision,
              rayleigh_ritz_finish=finish)
    jres = j_train_joint(cloud["jK"], cloud["jM"], cloud["X"], **kw)
    jparams = JJointEigenNet(TRAIN["hidden"], TRAIN["n_modes"]).init(
        jax.random.PRNGKey(TRAIN["seed"]),
        jnp.asarray(cloud["X"], jnp.float32))
    net = from_flax_params(JointEigenNet(3, TRAIN["hidden"],
                                         TRAIN["n_modes"]),
                           jax.tree_util.tree_map(np.asarray, jparams))
    res = train_joint(cloud["tK"], cloud["tM"], cloud["X"],
                      init_params=net.state_dict(), **kw)
    # In 'bf16' the residual term (~4e-4 of a loss ~1) moves by U's
    # rounding (F8), so only the loss trajectory is held, loosely.
    bf16 = precision == "bf16"
    tol = 1e-3 if bf16 else 1e-4
    assert res.epochs_run == jres.epochs_run == 30
    assert [n for n, _ in res.chunk_times] == [15, 15]
    for key in ("loss",) if bf16 else ("loss", "res", "orth", "lam_mean"):
        assert _rel(res.history[key], jres.history[key]) < tol, key
    assert res.eigenvectors.shape == (642, 5)
    assert np.isfinite(res.eigenvectors).all()
    assert _rel(res.eigenvalues, jres.eigenvalues) < tol


def test_train_joint_seeded_init_and_unported_options(cloud):
    res = train_joint(cloud["tK"], cloud["tM"], cloud["X"],
                      **dict(TRAIN, epochs=4, scan_chunk=2))
    assert res.history["loss"].shape == (4,)
    assert np.isfinite(res.eigenvalues).all()
    with pytest.raises(ValueError, match="mode"):
        train_joint(cloud["tK"], cloud["tM"], cloud["X"], mode="svd",
                    **dict(TRAIN, epochs=1))
    with pytest.raises(NotImplementedError, match="batch_nodes"):
        train_joint(cloud["tK"], cloud["tM"], cloud["X"],
                    **dict(TRAIN, epochs=1, batch_nodes=2))
    # The timing_chunks probe (ported) reports a rate and puts the
    # trained state back: the same history and eigenvalues as without.
    probed = train_joint(cloud["tK"], cloud["tM"], cloud["X"],
                         **dict(TRAIN, epochs=4, scan_chunk=2,
                                timing_chunks=2))
    assert probed.steady_steps_per_sec > 0
    np.testing.assert_array_equal(probed.history["loss"],
                                  res.history["loss"])
    np.testing.assert_array_equal(probed.eigenvalues, res.eigenvalues)


def test_make_cloud_is_the_bench_cloud():
    import bench

    np.testing.assert_array_equal(make_cloud(500, seed=3),
                                  bench.make_cloud(500, seed=3))
