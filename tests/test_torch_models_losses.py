"""Parity of the port's models, losses, optimizer and loop with JAX.

Models: flax parameters are carried into the torch modules with
`from_flax_params`; forward passes must agree to rel 1e-5 and parameter
gradients to rel 1e-4 (fp32 sums in another order). Losses: rel 1e-5,
their U-gradients rel 1e-4. Optimizer: the optax chain and the port's
`AdamPlateau` see the same gradients and loss values and must keep the
parameters within rel 1e-6 (fp32 rounding of one update) and the same
plateau scale. Loop: identical early-stop decisions and history.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu import losses as jlosses
from eigenpinns_tpu import sparse as jsparse
from eigenpinns_tpu.geometry import point_cloud_laplacian as j_pcl
from eigenpinns_tpu.models import MLP as JMLP
from eigenpinns_tpu.models import make_corrector as j_make_corrector
from eigenpinns_tpu.train.loop import run_scan_loop
from eigenpinns_tpu.train.optim import adam_plateau
from eigenpinns_torch import losses as tlosses
from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.models import MLP, from_flax_params, make_corrector
from eigenpinns_torch.train import AdamPlateau, run_chunked_loop


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _flat(tree):
    """Flax param tree -> {path: array}."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out["/".join(str(getattr(p, "key", p)) for p in path)] = leaf
    return out


def _torch_grad_of(module, path):
    """The torch parameter that a flax path names."""
    parts = [p for p in path.split("/") if p != "params"]
    mod = module
    if hasattr(mod, "inner") and parts[0] == "SimpleCorrector_0":
        mod, parts = mod.inner, parts[1:]
    if parts[0] == "mode_scales":
        return mod.mode_scales.grad.numpy()
    if parts[0] == "MLP_0":
        mod, parts = mod.mlp, parts[1:]
    name, leaf = parts
    layer = mod.out if name == "out" else mod.hidden[int(name.split("_")[1])]
    g = (layer.weight if leaf == "kernel" else layer.bias).grad.numpy()
    return g.T if leaf == "kernel" else g


def _check_module(jmodel, tmodel, jparams, x, *args):
    from_flax_params(tmodel, jax.tree_util.tree_map(np.asarray, jparams))

    def jloss(p):
        return jnp.sum(jnp.sin(jmodel.apply(p, jnp.asarray(x),
                                            *args[0::2])))

    out_j = np.asarray(jmodel.apply(jparams, jnp.asarray(x), *args[0::2]))
    grads_j = _flat(jax.grad(jloss)(jparams))
    out_t = tmodel(torch.from_numpy(x), *args[1::2])
    torch.sin(out_t).sum().backward()
    assert _rel(out_t.detach().numpy(), out_j) < 1e-5
    for path, gj in grads_j.items():
        assert _rel(_torch_grad_of(tmodel, path), gj) < 1e-4, path


def test_mlp_matches_flax_with_copied_params():
    x = np.random.default_rng(0).normal(size=(30, 9)).astype(np.float32)
    jm = JMLP((16, 16), 5, small_output_init=True)
    jp = jm.init(jax.random.PRNGKey(1), jnp.asarray(x))
    _check_module(jm, MLP(9, (16, 16), 5, small_output_init=True), jp, x)


@pytest.mark.parametrize("model_type", ["simple", "spectral", "adaptive"])
def test_correctors_match_flax_with_copied_params(model_type):
    rng = np.random.default_rng(2)
    n, f = 40, 6
    edges = np.stack([np.repeat(np.arange(n), 4),
                      rng.integers(0, n, size=4 * n)])
    build = ("gcn_normalized_adjacency" if model_type == "spectral"
             else "neighbor_mean_operator")
    jg = getattr(jsparse, build)(edges, n)
    tg = getattr(tsparse, build)(edges, n)
    x = rng.normal(size=(n, f)).astype(np.float32)
    jm = j_make_corrector(model_type, [16, 16], 4)
    jp = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jg)
    _check_module(jm, make_corrector(model_type, f, [16, 16], 4), jp, x,
                  jg, tg)


def test_mlp_bf16_compute_matches_flax():
    """compute_dtype='bfloat16': parameters stay fp32, the output is
    fp32; bf16 keeps ~3 digits and the frameworks round at different
    sites, so agreement is to rel 3e-2."""
    x = np.random.default_rng(4).normal(size=(64, 12)).astype(np.float32)
    jm = JMLP((32, 32), 6, compute_dtype="bfloat16")
    jp = jm.init(jax.random.PRNGKey(5), jnp.asarray(x))
    tm = from_flax_params(MLP(12, (32, 32), 6, compute_dtype="bfloat16"),
                          jax.tree_util.tree_map(np.asarray, jp))
    out_t = tm(torch.from_numpy(x))
    assert out_t.dtype == torch.float32
    assert tm.out.weight.dtype == torch.float32
    assert _rel(out_t.detach().numpy(),
                np.asarray(jm.apply(jp, jnp.asarray(x)))) < 3e-2


def test_seeded_init_follows_flax_initializers():
    """LeCun-normal hidden kernels (std 1/sqrt(fan_in)), N(0, 0.01^2)
    head, zero biases; the same seed gives the same parameters."""
    m = make_corrector("simple", 128, [256, 256], 10)
    m.reset_parameters(torch.Generator().manual_seed(0))
    w = m.mlp.hidden[1].weight.detach()
    assert abs(w.std().item() * 256**0.5 - 1.0) < 0.05
    assert w.abs().max().item() <= 2.0 / 256**0.5 / 0.8796 + 1e-6
    assert abs(m.mlp.out.weight.std().item() / 0.01 - 1.0) < 0.1
    assert all(float(layer.bias.detach().abs().max()) == 0.0
               for layer in [*m.mlp.hidden, m.mlp.out])
    m2 = make_corrector("simple", 128, [256, 256], 10)
    m2.reset_parameters(torch.Generator().manual_seed(0))
    assert torch.equal(m2.mlp.hidden[0].weight, m.mlp.hidden[0].weight)


@pytest.fixture(scope="module")
def loss_ops():
    r2 = np.random.default_rng(6)
    X = r2.normal(size=(300, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, M = j_pcl(X, n_neighbors=12)
    jK, perm = jsparse.RollingBanded.from_scipy(L)
    tK, _ = tsparse.RollingBanded.from_scipy(L)
    Lp = L.tocsr()[perm][:, perm]
    Mp = M.tocsr()[perm][:, perm]
    return {"rolling": (jK, tK), "ell": (jsparse.as_operator(Lp),
                                         tsparse.as_operator(Lp)),
            "M": (jsparse.as_operator(Mp), tsparse.as_operator(Mp))}


@pytest.mark.parametrize("kfmt", ["rolling", "ell"])
def test_losses_match_jax(loss_ops, kfmt):
    jK, tK = loss_ops[kfmt]
    jM, tM = loss_ops["M"]
    rng = np.random.default_rng(7)
    U = rng.normal(size=(300, 5)).astype(np.float32)
    Uc = rng.normal(size=(60, 5)).astype(np.float32)
    Pt = sp.random(60, 300, density=0.05, random_state=7, format="csr")
    jPt, tPt = jsparse.as_operator(Pt), tsparse.as_operator(Pt)
    lam_t = np.linspace(0, 2, 5).astype(np.float32)

    def jterms(u):
        lam, res, orth = jlosses.rayleigh_residual_orth(u, jK, jM)
        return [lam, res, orth, jlosses.trace_loss(lam),
                jlosses.ordering(lam[::-1]),
                jlosses.eigenvalue_target(lam, jnp.asarray(lam_t)),
                jlosses.zero_mean(u, jM),
                jlosses.projection(u, jPt, jnp.asarray(Uc))]

    def tterms(u):
        lam, res, orth = tlosses.rayleigh_residual_orth(u, tK, tM)
        return [lam, res, orth, tlosses.trace_loss(lam),
                tlosses.ordering(lam.flip(0)),
                tlosses.eigenvalue_target(lam, torch.from_numpy(lam_t)),
                tlosses.zero_mean(u, tM),
                tlosses.projection(u, tPt, torch.from_numpy(Uc))]

    Ut = torch.from_numpy(U).requires_grad_(True)
    tt = tterms(Ut)
    for t, j in zip(tt, jterms(jnp.asarray(U))):
        assert _rel(t.detach().numpy(), j) < 1e-5
    gj = jax.grad(lambda u: sum(jnp.sum(v) for v in jterms(u)))(
        jnp.asarray(U))
    sum(v.sum() for v in tt).backward()
    assert _rel(Ut.grad.numpy(), gj) < 1e-4


def test_adam_plateau_matches_optax():
    """Clipping on some steps and not others, weight decay, and loss
    values that plateau so the scale is cut three times (patience 3)."""
    rng = np.random.default_rng(8)
    shapes = [(3, 4), (4,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    values = np.array([5, 4, 3.9999, 3.9998, 3.9997, 3.9996, 3, 3, 3, 3,
                       3, 3, 2, 2.5, 2.5, 2.5, 2.5], np.float32)
    grads = [[(rng.normal(size=s) * (0.2 if i % 3 else 3.0)).astype(
        np.float32) for s in shapes] for i in range(len(values))]
    opt, plateau = adam_plateau(1e-2, weight_decay=1e-3, grad_clip=1.0,
                                plateau_factor=0.5, plateau_patience=3)
    jp = [jnp.asarray(p) for p in p0]
    os_, ps = opt.init(jp), plateau.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    topt = AdamPlateau(tp, 1e-2, weight_decay=1e-3, grad_clip=1.0,
                       plateau_factor=0.5, plateau_patience=3)
    for g, v in zip(grads, values):
        upd, os_ = opt.update([jnp.asarray(x) for x in g], os_, jp)
        upd, ps = plateau.update(upd, ps, value=jnp.asarray(v))
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x)
        topt.step(torch.tensor(v))
        for a, b in zip(tp, jp):
            assert _rel(a.detach().numpy(), b) < 1e-6
        assert float(topt.scale) == float(ps.scale)
    assert float(ps.scale) == 0.125


def test_chunked_loop_snapshots_best_params():
    """track_params: the snapshot is the parameters right after the step
    whose loss was lowest (the JAX loop's best_state)."""
    losses = [3.0, 1.0, 2.0, 0.5, 4.0, 5.0]
    p = torch.zeros(3)

    def step(e):
        p.fill_(float(e + 1))          # the update this step made
        return {"loss": torch.tensor(losses[e])}

    res = run_chunked_loop(step, n_epochs=6, chunk=4, track_params=[p])
    assert res.epochs_run == 6 and not res.stopped_early
    assert torch.equal(res.best_params[0], torch.full((3,), 4.0))
    assert [n for n, _ in res.chunk_times] == [4, 2]


def test_chunked_loop_matches_scan_loop_early_stop():
    losses = np.array([5, 4, 3, 3.5, 3.6, 2.9, 3.0, 3.1, 3.2, 3.3, 3.4,
                       3.5], np.float32)
    jres = run_scan_loop(
        lambda s, e, d: (s, {"loss": d[e]}), jnp.zeros(()),
        n_epochs=len(losses), chunk=3, early_stop_patience=2,
        data=jnp.asarray(losses))
    tres = run_chunked_loop(lambda e: {"loss": torch.tensor(losses[e])},
                            n_epochs=len(losses), chunk=3,
                            early_stop_patience=2)
    assert tres.epochs_run == jres.epochs_run < len(losses)
    assert tres.stopped_early and jres.stopped_early
    np.testing.assert_array_equal(tres.history["loss"],
                                  jres.history["loss"])
