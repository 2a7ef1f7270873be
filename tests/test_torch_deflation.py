"""Parity of the port's deflation drivers and their parts with JAX.

The same numpy inputs go through both packages on the CPU: a 300-point
cloud on an ellipsoid (axes 1, 1.5, 2.2, so that the low modes are well
separated), its point-cloud Laplacian from the port's numpy host code,
handed to both packages as `as_operator` ELL matrices, and the flax
parameters of every network carried in through `init_params`.
Tolerances (relative to the largest magnitude compared):

  * `LambdaEigenNet` forward and parameter gradients: rel 1e-5, with
    lambda_raw = 0 (the deflation's first mode, where JAX's abs has
    derivative +1) and lambda_raw > 0;
  * `solve_deflation`, 2 modes at hidden (16, 16): the loss, lambda and
    normalization histories epoch by epoch, the eigenvalues and the
    eigenvectors (up to sign) rel 1e-4, without the polish and with a
    200-iteration one (both LOBPCGs converge there; their eigenvalues
    differ by ~3e-5 relative, the JAX package reading them off the fp32
    Gram, ROADMAP F9);
  * `solve_deflation_adaptive` with `perturb_factor=0`,
    `minibatch=None` and the ema_slope trigger (it fires at the warmup
    epoch, so both packages store at the same epochs): the epoch-by-epoch
    histories, both stored eigenvalues and the first stored mode rel 1e-4
    (the JAX row permutation only reorders sums);
  * `run_chunked_loop`'s below_tol early stop against `run_scan_loop` on
    the same metric stream: equal stop epoch and history.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenpinns_tpu.models import LambdaEigenNet as JLambdaEigenNet
from eigenpinns_tpu.solvers.deflation import solve_deflation as j_solve
from eigenpinns_tpu.solvers.deflation import (
    solve_deflation_adaptive as j_solve_adaptive,
)
from eigenpinns_tpu.sparse import as_operator as j_as_operator
from eigenpinns_tpu.train.loop import run_scan_loop
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.models import LambdaEigenNet, from_flax_params
from eigenpinns_torch.solvers import solve_deflation, solve_deflation_adaptive
from eigenpinns_torch.sparse import as_operator
from eigenpinns_torch.train import run_chunked_loop

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)

HIDDEN = (16, 16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _signed(U, V):
    """U with each column's sign matched to V's."""
    return U * np.sign((U * V).sum(0))


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    X = rng.normal(size=(300, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X *= np.array([1.0, 1.5, 2.2])
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    return {"X": X.astype(np.float32),
            "j": (j_as_operator(L), j_as_operator(M)),
            "t": (as_operator(L, device="cpu"), as_operator(M, device="cpu"))}


def _flax_state(key, X):
    """A torch state_dict of `JLambdaEigenNet(HIDDEN).init(key, X)`."""
    tree = JLambdaEigenNet(HIDDEN).init(key, jnp.asarray(X))
    net = LambdaEigenNet(X.shape[1], HIDDEN)
    from_flax_params(net, jax.tree_util.tree_map(np.asarray, tree))
    return net.state_dict()


@pytest.mark.parametrize("lambda_init", [0.0, 0.7])
def test_lambda_eigen_net_matches_flax(lambda_init):
    x = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    jm = JLambdaEigenNet(HIDDEN, lambda_init=lambda_init)
    jp = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))

    def f(p):
        u, lam = jm.apply(p, jnp.asarray(x))
        return jnp.sum(jnp.sin(u)) + 3.0 * lam

    gj = jax.grad(f)(jp)["params"]
    tm = LambdaEigenNet(3, HIDDEN, lambda_init=lambda_init)
    from_flax_params(tm, jax.tree_util.tree_map(np.asarray, jp))
    u, lam = tm(torch.from_numpy(x))
    (torch.sin(u).sum() + 3.0 * lam).backward()
    uj, lamj = jm.apply(jp, jnp.asarray(x))
    assert _rel(u.detach().numpy(), uj) < 1e-5
    assert float(lam.detach()) == pytest.approx(float(lamj), abs=1e-7)
    assert _rel(tm.lambda_raw.grad.numpy(), gj["lambda_raw"]) < 1e-5
    for i, layer in enumerate(tm.layers()):
        name = "out" if layer is tm.out else f"hidden_{i}"
        assert _rel(layer.weight.grad.numpy().T, gj[name]["kernel"]) < 1e-5
        assert _rel(layer.bias.grad.numpy(), gj[name]["bias"]) < 1e-5


@pytest.mark.parametrize("polish", [0, 200])
def test_solve_deflation_matches_jax(problem, polish):
    X = problem["X"]
    kw = dict(hidden=HIDDEN, epochs_per_mode=80, scan_chunk=40, lr=2e-3,
              seed=0, polish_iters=polish, lambda_delta=0.5, w_defl=300.0)
    jr = j_solve(*problem["j"], X, 2, **kw)
    init = [_flax_state(jax.random.PRNGKey(m), X) for m in range(2)]
    tr = solve_deflation(*problem["t"], X, 2, init_params=init, **kw)
    assert tr.epochs_per_mode == jr.epochs_per_mode == [80, 80]
    for m in range(2):
        for key in ("loss", "lam", "norm"):
            assert _rel(tr.histories[m][key], jr.histories[m][key]) < 1e-4, (
                m, key)
    assert _rel(tr.eigenvalues, jr.eigenvalues) < 1e-4
    assert _rel(_signed(tr.eigenvectors, jr.eigenvectors),
                jr.eigenvectors) < 1e-4
    if polish:
        assert _rel(tr.histories[1]["polished_lambda"],
                    jr.histories[1]["polished_lambda"]) < 1e-4


def test_solve_deflation_adaptive_matches_jax(problem):
    X = problem["X"]
    kw = dict(hidden=HIDDEN, epochs=160, scan_chunk=40, lr=2e-3,
              minibatch=None, perturb_factor=0.0, trigger="ema_slope",
              reinit_threshold=1e2, warmup_epochs=50, min_epochs_between=50,
              seed=0)
    jr = j_solve_adaptive(*problem["j"], X, 2, **kw)
    assert jr.epochs_per_mode == [50, 100]
    # The JAX driver's (re)initializations: PRNGKey(seed), then at each
    # store fold_in(k_reinit of the store's epoch, modes stored before).
    init = [_flax_state(jax.random.PRNGKey(0), X)]
    for count, epoch in enumerate(jr.epochs_per_mode):
        key = jax.random.fold_in(jax.random.PRNGKey(0), epoch)
        k_reinit = jax.random.split(key, 3)[2]
        init.append(_flax_state(jax.random.fold_in(k_reinit, count), X))
    tr = solve_deflation_adaptive(*problem["t"], X, 2, init_params=init,
                                  **kw)
    assert tr.epochs_per_mode == jr.epochs_per_mode
    assert tr.histories[0]["epochs_run"] == jr.histories[0]["epochs_run"]
    for key in ("loss", "lam", "smooth_loss", "ema_slope", "flat", "found"):
        assert _rel(tr.histories[0][key], jr.histories[0][key]) < 1e-4, key
    assert _rel(tr.eigenvalues, jr.eigenvalues) < 1e-4
    # The first stored mode; the second network has trained only 50
    # epochs when it is stored, and its mode agrees to ~3e-4.
    assert _rel(_signed(tr.eigenvectors, jr.eigenvectors)[:, 0],
                jr.eigenvectors[:, 0]) < 1e-4


def test_chunked_loop_below_tol_matches_scan_loop():
    """The EMA-slope stop: the counter runs while |metric| < tol, resets
    otherwise; best-tracking follows the loss."""
    vals = np.array([5, 0.5, 0.2, 3, 0.1, 0.1, 0.1, 0.1, 0.1, 0.1, 2, 1],
                    np.float32)
    losses = np.linspace(2.0, 1.0, len(vals)).astype(np.float32)

    def j_step(state, epoch):
        return state, {"loss": jnp.asarray(losses)[epoch],
                       "slope": jnp.asarray(vals)[epoch]}

    jr = run_scan_loop(j_step, jnp.zeros(()), n_epochs=12, chunk=2,
                       early_stop_patience=3, early_stop_metric="slope",
                       early_stop_mode="below_tol", early_stop_tol=0.3)

    def t_step(epoch):
        return {"loss": torch.tensor(losses[epoch]),
                "slope": torch.tensor(vals[epoch])}

    tr = run_chunked_loop(t_step, n_epochs=12, chunk=2,
                          early_stop_patience=3, early_stop_metric="slope",
                          early_stop_mode="below_tol", early_stop_tol=0.3)
    assert tr.stopped_early and jr.stopped_early
    assert tr.epochs_run == jr.epochs_run == 8
    for key in ("loss", "slope"):
        np.testing.assert_array_equal(tr.history[key], jr.history[key])
    with pytest.raises(ValueError):
        run_chunked_loop(t_step, n_epochs=2, early_stop_mode="flat")
