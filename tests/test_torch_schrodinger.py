"""Parity of the port's Schrodinger operators, ansatz and driver with JAX.

The same numpy inputs go through both packages on the CPU, with the
flax parameters of every network carried in through `from_flax_params`
or the driver's `init_params`. Tolerances (relative to the largest
magnitude compared):

  * `second_derivative_1d`, `laplacian_nd` (d = 3), `hutchinson_laplacian`
    (JAX's Rademacher probes fed in) and `schrodinger_residual` on a
    tanh MLP, and the parameter gradients of a loss on the residual:
    rel 1e-5;
  * the potentials and analytic spectra: exact (float32);
  * `ParametricAnsatz` and `SchrodingerMode` forward and parameter
    gradients, lambda_raw's included (at lambda_raw = 0, where JAX's abs
    has derivative +1): rel 1e-5;
  * `solve_schrodinger`, 60 epochs a mode at hidden (16, 16), batch 32,
    quad 64, with JAX's collocation draws (fold_in(PRNGKey(seed + 7 m),
    epoch) -> uniform, rebuilt here) fed through `draws`: the loss,
    lambda and norm histories epoch by epoch, the eigenvalues and the
    last mode on a few points rel 1e-4; two modes of the oscillator in 1D
    and on a 2D box, the ground state of the well in 1D and on the unit
    box (why not two: `PROBLEMS`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenpinns_tpu.models import ParametricAnsatz as JParametricAnsatz
from eigenpinns_tpu.models import dirichlet_window as j_dirichlet_window
from eigenpinns_tpu.models import gaussian_window as j_gaussian_window
from eigenpinns_tpu.models.mlp import MLP as JMLP
from eigenpinns_tpu import operators as jops
from eigenpinns_tpu.solvers import SchrodingerMode as JSchrodingerMode
from eigenpinns_tpu.solvers import solve_schrodinger as j_solve
from eigenpinns_torch import operators as tops
from eigenpinns_torch.models import (
    MLP,
    ParametricAnsatz,
    dirichlet_window,
    from_flax_params,
    gaussian_window,
)
from eigenpinns_torch.solvers import SchrodingerMode, solve_schrodinger

torch.set_num_threads(2)

HIDDEN = (16, 16)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _tree(p):
    return jax.tree_util.tree_map(np.asarray, p)


def _mlp_pair(d, seed=0):
    jm = JMLP(HIDDEN, 1, activation="tanh")
    jp = jm.init(jax.random.PRNGKey(seed), jnp.zeros((4, d), jnp.float32))
    tm = from_flax_params(MLP(d, HIDDEN, 1, activation="tanh"), _tree(jp))
    return (lambda x: jm.apply(jp, x)[:, 0]), (lambda x: tm(x)[:, 0]), jp, tm


def _points(n, d, seed=1):
    return np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)


@pytest.mark.parametrize("name", ["second_derivative_1d", "laplacian_nd",
                                  "hutchinson_laplacian"])
def test_derivative_operators_match_jax(name):
    d = 1 if name == "second_derivative_1d" else 3
    j_u, t_u, _, _ = _mlp_pair(d)
    x = _points(40, d)
    if name == "hutchinson_laplacian":
        key = jax.random.PRNGKey(5)
        ref = jops.hutchinson_laplacian(j_u, jnp.asarray(x), key, n_probes=6)
        probes = np.array(jax.random.rademacher(key, (6, d),
                                                dtype=jnp.float32))
        got = tops.hutchinson_laplacian(t_u, torch.from_numpy(x),
                                        probes=torch.from_numpy(probes))
    else:
        ref = getattr(jops, name)(j_u, jnp.asarray(x))
        got = getattr(tops, name)(t_u, torch.from_numpy(x))
    assert got.shape == (40,)
    assert _rel(got.detach().numpy(), ref) < 1e-5


def test_hutchinson_draws_rademacher_probes():
    """With generated probes the estimate of a quadratic's Hessian trace
    (H = 2I) is exact, as in the JAX package's test."""
    x = torch.from_numpy(_points(6, 5))
    lap = tops.hutchinson_laplacian(lambda z: torch.sum(z**2, dim=-1), x,
                                    torch.Generator().manual_seed(0),
                                    n_probes=16)
    assert torch.allclose(lap, torch.full((6,), 10.0), atol=1e-4)


@pytest.mark.parametrize("d", [1, 2])
def test_schrodinger_residual_and_its_gradient_match_jax(d):
    """The residual and the parameter gradients of mean(r^2) through its
    second derivatives."""
    j_u, t_u, jp, tm = _mlp_pair(d, seed=2)
    jm = JMLP(HIDDEN, 1, activation="tanh")
    x = _points(32, d, seed=3)
    lam = 0.7

    def j_loss(p):
        r = jops.schrodinger_residual(lambda z: jm.apply(p, z)[:, 0],
                                      jops.harmonic_oscillator(1.3), lam,
                                      jnp.asarray(x))
        return jnp.mean(r * r), r

    (_, r_j), g_j = jax.value_and_grad(j_loss, has_aux=True)(jp)
    r_t = tops.schrodinger_residual(t_u, tops.harmonic_oscillator(1.3), lam,
                                    torch.from_numpy(x))
    torch.mean(r_t * r_t).backward()
    assert _rel(r_t.detach().numpy(), r_j) < 1e-5
    g_j = g_j["params"]
    for i, layer in enumerate([*tm.hidden, tm.out]):
        name = "out" if layer is tm.out else f"hidden_{i}"
        assert _rel(layer.weight.grad.numpy().T, g_j[name]["kernel"]) < 1e-5
        assert _rel(layer.bias.grad.numpy(), g_j[name]["bias"]) < 1e-5


def test_analytic_helpers_are_exact():
    np.testing.assert_array_equal(tops.well_eigenvalues(4, L=1.5).numpy(),
                                  np.asarray(jops.well_eigenvalues(4, L=1.5)))
    np.testing.assert_array_equal(
        tops.oscillator_eigenvalues(5, omega=0.7).numpy(),
        np.asarray(jops.oscillator_eigenvalues(5, omega=0.7)))
    x = _points(9, 3)
    np.testing.assert_array_equal(
        tops.harmonic_oscillator(1.3)(torch.from_numpy(x)).numpy(),
        np.asarray(jops.harmonic_oscillator(1.3)(jnp.asarray(x))))
    np.testing.assert_array_equal(
        tops.infinite_well()(torch.from_numpy(x)).numpy(), np.zeros(9))
    u, v = _points(50, 1)[:, 0], _points(50, 1, seed=4)[:, 0]
    for t_fn, j_fn, args in ((tops.mc_norm_sq, jops.mc_norm_sq, (u,)),
                             (tops.mc_inner, jops.mc_inner, (u, v))):
        got = t_fn(*map(torch.from_numpy, args), 2.5)
        assert float(got) == pytest.approx(
            float(j_fn(*map(jnp.asarray, args), 2.5)), rel=1e-6)


def test_parametric_ansatz_matches_flax():
    x = np.random.default_rng(0).uniform(-2, 2, size=(30, 1)).astype(
        np.float32)
    lam = np.asarray([0.5, 1.5, 2.5], np.float32)
    jm = JParametricAnsatz(HIDDEN, j_gaussian_window(1.2),
                           boundary=lambda z: 0.1 * z[:, 0])
    jp = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(lam))

    def f(p):
        return jnp.sum(jnp.sin(jm.apply(p, jnp.asarray(x), jnp.asarray(lam))))

    gj = jax.grad(f)(jp)["params"]["MLP_0"]
    tm = from_flax_params(ParametricAnsatz(1, HIDDEN, gaussian_window(1.2),
                                           boundary=lambda z: 0.1 * z[:, 0]),
                          _tree(jp))
    out = tm(torch.from_numpy(x), torch.from_numpy(lam))
    assert out.shape == (30, 3)
    assert _rel(out.detach().numpy(),
                jm.apply(jp, jnp.asarray(x), jnp.asarray(lam))) < 1e-5
    torch.sin(out).sum().backward()
    for i, layer in enumerate([*tm.mlp.hidden, tm.mlp.out]):
        name = "out" if layer is tm.mlp.out else f"hidden_{i}"
        assert _rel(layer.weight.grad.numpy().T, gj[name]["kernel"]) < 1e-5
        assert _rel(layer.bias.grad.numpy(), gj[name]["bias"]) < 1e-5


@pytest.mark.parametrize("lambda_init", [0.0, 1.3])
def test_schrodinger_mode_matches_flax(lambda_init):
    x = np.random.default_rng(1).uniform(0, 1, size=(25, 1)).astype(
        np.float32)
    jm = JSchrodingerMode(HIDDEN, j_dirichlet_window(0.0, 1.0),
                          lambda_init=lambda_init)
    jp = jm.init(jax.random.PRNGKey(4), jnp.asarray(x))

    def f(p):
        u, lam = jm.apply(p, jnp.asarray(x))
        return jnp.sum(jnp.cos(u)) + 2.0 * lam

    gj = jax.grad(f)(jp)["params"]
    tm = from_flax_params(
        SchrodingerMode(1, HIDDEN, dirichlet_window(0.0, 1.0),
                        lambda_init=lambda_init), _tree(jp))
    u, lam = tm(torch.from_numpy(x))
    uj, lamj = jm.apply(jp, jnp.asarray(x))
    assert _rel(u.detach().numpy(), uj) < 1e-5
    assert float(lam.detach()) == float(lamj)
    (torch.cos(u).sum() + 2.0 * lam).backward()
    assert _rel(tm.lambda_raw.grad.numpy(), gj["lambda_raw"]) < 1e-5
    for i, layer in enumerate([*tm.mlp.hidden, tm.mlp.out]):
        name = "out" if layer is tm.mlp.out else f"hidden_{i}"
        assert _rel(layer.weight.grad.numpy().T,
                    gj["MLP_0"][name]["kernel"]) < 1e-5
        assert _rel(layer.bias.grad.numpy(), gj["MLP_0"][name]["bias"]) < 1e-5


def _window2d(x):
    """The JAX slow test's window on (0, 1)^2, for arrays of either
    package."""
    return x[:, 0] * (1 - x[:, 0]) * x[:, 1] * (1 - x[:, 1])


# (potential and window of each package, domain, lambda_init,
# lambda_growth, modes). The oscillators run two modes, so the deflation
# term and the warm start of mode 1 are held in 1D and on a 2D box. The
# well and the unit box run their ground state at the examples' warm
# starts: their mode 1 starts at lambda ~ 8-13, where the lambda input
# saturates the first tanh layer and Adam turns the rounding noise of the
# near-zero gradients into full steps, so the two packages' losses part
# at ~1e-4 within 60 epochs while lambda agrees to 1e-7 (ROADMAP F21).
PROBLEMS = {
    "oscillator_1d": ((jops.harmonic_oscillator(), j_gaussian_window(1.0)),
                      (tops.harmonic_oscillator(), gaussian_window(1.0)),
                      (-4.0, 4.0), 0.4, 2.5, 2),
    "oscillator_box_2d": ((jops.harmonic_oscillator(),
                           j_gaussian_window(1.0)),
                          (tops.harmonic_oscillator(), gaussian_window(1.0)),
                          [(-3.0, 3.0), (-3.0, 3.0)], 0.8, 1.6, 2),
    "well_1d": ((jops.infinite_well(), j_dirichlet_window(0.0, 1.0)),
                (tops.infinite_well(), dirichlet_window(0.0, 1.0)),
                (0.0, 1.0), 3.0, 2.5, 1),
    "well_box_2d": ((jops.infinite_well(), _window2d),
                    (tops.infinite_well(), _window2d),
                    [(0.0, 1.0), (0.0, 1.0)], 8.0, 1.6, 1),
}


@pytest.mark.parametrize("problem", sorted(PROBLEMS))
def test_solve_schrodinger_matches_jax(problem):
    j_fns, t_fns, domain, lambda_init, growth, n_modes = PROBLEMS[problem]
    seed, epochs, batch, quad = 1, 60, 32, 64
    kw = dict(hidden=HIDDEN, epochs_per_mode=epochs, scan_chunk=20,
              batch_size=batch, quad_points=quad, lr=3e-3, seed=seed,
              lambda_init=lambda_init, lambda_growth=growth)
    jr = j_solve(*j_fns, domain, n_modes, **kw)
    d = np.asarray(domain, np.float64).reshape(-1, 2).shape[0]
    # The JAX driver's initializations (PRNGKey(seed + 31 m); the MLP's
    # weights do not depend on lambda_init) and collocation draws.
    init = []
    for m in range(n_modes):
        jp = JSchrodingerMode(HIDDEN, j_fns[1]).init(
            jax.random.PRNGKey(seed + 31 * m), jnp.zeros((4, d), jnp.float32))
        init.append(from_flax_params(
            SchrodingerMode(d, HIDDEN, t_fns[1]), _tree(jp)).state_dict())
    draws = {m: np.array(jax.vmap(lambda e, m=m: jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed + 7 * m), e), (batch, d),
        dtype=jnp.float32))(jnp.arange(epochs))) for m in range(n_modes)}
    tr = solve_schrodinger(*t_fns, domain, n_modes, device="cpu",
                           init_params=init,
                           draws=lambda m, e: draws[m][e], **kw)
    for m in range(n_modes):
        for key in ("loss", "lam", "norm"):
            assert tr.histories[m][key].shape == (epochs,)
            assert _rel(tr.histories[m][key], jr.histories[m][key]) < 1e-4, (
                m, key)
    assert _rel(tr.eigenvalues, jr.eigenvalues) < 1e-4
    x = np.linspace(0.05, 0.95, 7, dtype=np.float32)
    x = np.stack([x] * d, axis=1)
    assert _rel(tr.eval_mode(n_modes - 1, x),
                jr.eval_mode(n_modes - 1, x)) < 1e-4


def test_solve_schrodinger_defaults_to_the_card():
    import inspect

    assert inspect.signature(solve_schrodinger).parameters[
        "device"].default == "cuda"
