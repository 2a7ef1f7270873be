"""Parity of the port's eikonal operator, heat geodesics and eikonal
driver with JAX.

The same numpy inputs go through both packages on the CPU: icosphere(2)
and perturbed_icosphere(2) (162 vertices), their exact encodings from
the port's `solve_eigenvalue_mesh`, and flax parameters carried in
through `init_params`. Tolerances:

  * `gradient_norm_operator`: abs 1e-12 (both float64 on the host);
  * `eikonal_residual`: rel 1e-6 (float32) on a random field, and abs
    1e-6 on the flat triangle pair with u = x, where |grad u| = 1;
  * `heat_geodesics`: abs 1e-10 (both scipy on the host);
  * the NTK traces at fixed parameters and element indices: rel 1e-5
    against JAX's per-example gradients (`jax.vmap(jax.grad)`, the JAX
    driver's own trace code, rebuilt here);
  * `solve_eikonal`, 120 epochs with NTK weighting every 40 epochs and
    JAX's draws (fold_in(PRNGKey(seed + 1), epoch), split, randint,
    rebuilt here) fed through `draws`: every history key epoch by epoch,
    the final field, `data_mse` and `residual_rms` rel 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenpinns_tpu.geometry import TriMesh as JTriMesh
from eigenpinns_tpu.geometry import heat_geodesics as j_heat
from eigenpinns_tpu.models.mlp import MLP as JMLP
from eigenpinns_tpu.operators import eikonal_residual as j_residual
from eigenpinns_tpu.operators import gradient_norm_operator as j_bs
from eigenpinns_tpu.solvers import solve_eikonal as j_solve
from eigenpinns_torch.geometry import heat_geodesics
from eigenpinns_torch.models import MLP, from_flax_params
from eigenpinns_torch.operators import (
    eigen_positional_encoding,
    eikonal_residual,
    gradient_norm_operator,
)
from eigenpinns_torch.solvers import ntk_traces, solve_eikonal
from eigenpinns_torch.solvers.oracle import solve_eigenvalue_mesh
from eigenpinns_torch.utils.fixtures import icosphere, perturbed_icosphere

torch.set_num_threads(2)

MESHES = {"icosphere": lambda: icosphere(2),
          "perturbed_icosphere": lambda: perturbed_icosphere(2)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _j_mesh(mesh):
    return JTriMesh(mesh.verts, mesh.faces)


@pytest.fixture(scope="module")
def problem():
    mesh = perturbed_icosphere(2)
    src = int(np.argmax(mesh.verts[:, 2]))
    y = heat_geodesics(mesh, [src])
    _, vecs, _, _ = solve_eigenvalue_mesh(mesh, 10)
    return mesh, eigen_positional_encoding(vecs, 10), y


@pytest.mark.parametrize("name", sorted(MESHES))
def test_gradient_norm_operator_and_residual_match_jax(name):
    mesh = MESHES[name]()
    Bs = gradient_norm_operator(mesh.verts, mesh.faces)
    Bs_j = j_bs(mesh.verts, mesh.faces)
    assert Bs.shape == (mesh.n_faces, 3, 3)
    assert np.abs(Bs - Bs_j).max() < 1e-12
    u = np.random.default_rng(0).normal(size=mesh.n_verts).astype(np.float32)
    r = eikonal_residual(torch.from_numpy(u), torch.as_tensor(
        Bs, dtype=torch.float32), torch.as_tensor(mesh.faces, dtype=torch.int64))
    r_j = j_residual(jnp.asarray(u), jnp.asarray(Bs_j, jnp.float32),
                     jnp.asarray(mesh.faces))
    assert _rel(r.numpy(), r_j) < 1e-6


def test_eikonal_residual_of_a_linear_field_is_zero():
    """u = x on a flat triangle pair has |grad u| = 1 (the JAX test)."""
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0]], float)
    faces = np.array([[0, 1, 2], [1, 3, 2]])
    Bs = torch.as_tensor(gradient_norm_operator(verts, faces),
                         dtype=torch.float32)
    r = eikonal_residual(torch.as_tensor(verts[:, 0], dtype=torch.float32),
                         Bs, torch.as_tensor(faces))
    assert r.abs().max() < 1e-6


@pytest.mark.parametrize("name", sorted(MESHES))
def test_heat_geodesics_match_jax(name):
    mesh = MESHES[name]()
    for sources in ([0], [int(np.argmax(mesh.verts[:, 2])), 5]):
        d = heat_geodesics(mesh, sources)
        d_j = j_heat(_j_mesh(mesh), sources)
        assert d.shape == (mesh.n_verts,)
        assert np.abs(d - d_j).max() < 1e-10


def _j_traces(jm, jp, enc, data_idx, faces, Bs, y_sigma, e_idx):
    """The JAX driver's `ntk_traces` (eikonal_driver.py:127-165) on given
    element indices."""
    def sq_sum(tree):
        return sum(jnp.sum(g**2) for g in jax.tree_util.tree_leaves(tree))

    def u_i(p, x):
        return jm.apply(p, x[None])[0, 0]

    g_u = jax.vmap(jax.grad(u_i), in_axes=(None, 0))(jp, enc[data_idx])

    def r_e(p, f, B):
        u_e = jm.apply(p, enc[f])[:, 0] * y_sigma
        quad = jnp.einsum("ij,i,j->", B, u_e, u_e)
        return jnp.sqrt(jnp.clip(quad, 1e-12)) - 1.0

    g_r = jax.vmap(jax.grad(r_e), in_axes=(None, 0, 0))(
        jp, faces[e_idx], Bs[e_idx])
    return (float(sq_sum(g_u) / data_idx.shape[0]),
            float(sq_sum(g_r) / e_idx.shape[0]))


def test_ntk_traces_match_jax(problem):
    mesh, enc, y = problem
    jm = JMLP((32,), 1, activation="tanh")
    jp = jm.init(jax.random.PRNGKey(2), jnp.asarray(enc[:4]))
    rng = np.random.default_rng(1)
    data_idx = rng.choice(mesh.n_verts, 20, replace=False)
    e_idx = rng.integers(0, mesh.n_faces, 48)
    Bs = gradient_norm_operator(mesh.verts, mesh.faces).astype(np.float32)
    y_sigma = float(np.std(y))
    ref = _j_traces(jm, jp, jnp.asarray(enc), jnp.asarray(data_idx),
                    jnp.asarray(mesh.faces), jnp.asarray(Bs), y_sigma,
                    jnp.asarray(e_idx))
    tm = from_flax_params(MLP(10, (32,), 1, activation="tanh"),
                          jax.tree_util.tree_map(np.asarray, jp))
    got = ntk_traces(tm, torch.from_numpy(enc), torch.from_numpy(data_idx),
                     torch.as_tensor(mesh.faces, dtype=torch.int64),
                     torch.from_numpy(Bs), y_sigma, torch.from_numpy(e_idx))
    for g, r in zip(got, ref):
        assert float(g) == pytest.approx(r, rel=1e-5)


@pytest.mark.parametrize("ntk", [False, True])
def test_solve_eikonal_matches_jax(problem, ntk):
    mesh, enc, y = problem
    seed, epochs, batch, ntk_batch = 0, 120, 64, 32
    kw = dict(n_data=30, hidden=(32,), epochs=epochs, scan_chunk=40,
              element_batch=batch, lr=3e-3, lr_decay_steps=100,
              ntk_weights=ntk, ntk_every=40, ntk_batch=ntk_batch, seed=seed)
    jr = j_solve(_j_mesh(mesh), enc, y, **kw)
    # The JAX driver's initialization and its per-epoch draws.
    jp = JMLP((32,), 1, activation="tanh").init(jax.random.PRNGKey(seed),
                                               jnp.asarray(enc[:4]))
    init = from_flax_params(MLP(10, (32,), 1, activation="tanh"),
                            jax.tree_util.tree_map(np.asarray, jp))

    def keys(e):
        k_batch, k_ntk = jax.random.split(
            jax.random.fold_in(jax.random.PRNGKey(seed + 1), e))
        return (jax.random.randint(k_batch, (batch,), 0, mesh.n_faces),
                jax.random.randint(k_ntk, (ntk_batch,), 0, mesh.n_faces))

    e_idx, ntk_idx = map(np.array, jax.vmap(keys)(jnp.arange(epochs)))
    tr = solve_eikonal(mesh, enc, y, device="cpu",
                       init_params=init.state_dict(),
                       draws=lambda e: (e_idx[e], ntk_idx[e]), **kw)
    assert sorted(tr.history) == sorted(jr.history) == [
        "data", "loss", "res", "w_r", "w_u"]
    for key in tr.history:
        assert tr.history[key].shape == (epochs,)
        assert _rel(tr.history[key], jr.history[key]) < 1e-4, key
    if ntk:
        w_u = tr.history["w_u"]
        assert np.all(w_u[1:40] == w_u[1]) and w_u[40] != w_u[39]
        assert abs(1 / w_u[-1] + 1 / tr.history["w_r"][-1] - 1) < 1e-4
    assert _rel(tr.u, jr.u) < 1e-4
    assert tr.data_mse == pytest.approx(jr.data_mse, rel=1e-4)
    assert tr.residual_rms == pytest.approx(jr.residual_rms, rel=1e-4)


def test_solve_eikonal_defaults_to_the_card():
    import inspect

    assert inspect.signature(solve_eikonal).parameters[
        "device"].default == "cuda"
