"""Parity of the port's remaining public functions with the JAX package.

The same numpy inputs, made from a seed, go through both packages.
Tolerances:

  * `normalize_columns`, `neighbor_mean`: rel 1e-6 (fp32 sums in another
    order);
  * `block_diag_ell`: indices and values equal, its SpMM rel 1e-6;
  * `SimpleCorrector` on a (2, E) edge_index, flax parameters carried
    in: rel 1e-5;
  * `smooth_eigenfunctions` (tau 0.1) on the sphere problem's ELL K and
    on its `RollingBanded` K (JAX on its CPU reference path), each with
    a Diagonal M, in fp32: rel 1e-4 at 10 CG iterations; at the default
    30, where the iterate is chaotic in both packages (see the test),
    the port's distance to the exact fp64 solve at most twice JAX's;
  * `m_orthonormalize_cholesky`: rel 1e-5, and U^T M U = I to 1e-5;
  * `adamw_cosine_restarts`: the schedule equals optax's at every step
    of three cycles to rel 1e-6 (fp32 `cos` in another library), and
    the parameters after 50 updates of a fixed gradient sequence that
    crosses two restarts to rel 1e-6, with the clip active and off;
  * `point_cloud_laplacian(cover="tufted", use_native=False)`: L and M
    equal the JAX package's to 1e-12, with the structural checks of
    tests/test_geometry.py::test_tufted_double_cover_matches_paired.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import eigsh, spsolve

from eigenpinns_tpu import sparse as jsparse
from eigenpinns_tpu.geometry import point_cloud_laplacian as j_pcl
from eigenpinns_tpu.models import SimpleCorrector as JSimpleCorrector
from eigenpinns_tpu.solvers.smoothers import (
    m_orthonormalize_cholesky as j_m_orth,
)
from eigenpinns_tpu.solvers.smoothers import (
    smooth_eigenfunctions as j_smooth,
)
from eigenpinns_tpu.train.optim import (
    adamw_cosine_restarts as j_adamw_cosine_restarts,
)
from eigenpinns_torch import ops as tops
from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.models import SimpleCorrector, from_flax_params
from eigenpinns_torch.solvers import (
    m_orthonormalize_cholesky,
    smooth_eigenfunctions,
)
from eigenpinns_torch.train import adamw_cosine_restarts

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _edges(n, e, seed):
    r = np.random.default_rng(seed)
    return np.stack([r.integers(0, n, e), r.integers(0, n, e)]).astype(
        np.int64)


@pytest.fixture(scope="module")
def sphere():
    """The sphere problem of tests/test_direct_deflation.py (300 points,
    15 neighbors), its 6 smallest eigenpairs, and a noisy start."""
    r = np.random.default_rng(3)
    X = r.normal(size=(300, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    vecs = scipy.linalg.eigh(L.toarray(), M.toarray())[1][:, :6]
    U0 = (vecs + 1e-2 * np.abs(vecs).max()
          * np.random.default_rng(4).normal(size=vecs.shape))
    return L.tocsr(), M.tocsr(), U0.astype(np.float32)


def test_normalize_columns_matches_jax():
    U = np.random.default_rng(0).normal(size=(200, 7)).astype(np.float32)
    t_u, t_n = tops.normalize_columns(_t(U))
    j_u, j_n = jsparse.normalize_columns(jnp.asarray(U))
    assert _rel(t_u.numpy(), j_u) < 1e-6
    assert _rel(t_n.numpy(), j_n) < 1e-6


@pytest.mark.parametrize("k", [1, 5])
def test_neighbor_mean_matches_jax(k):
    n = 120
    edges = _edges(n, 700, k)
    edges[0] %= n - 10          # the last 10 nodes have no in-edge
    edges[:, :5] = 3            # repeated edges and self-loops count
    x = np.random.default_rng(1).normal(size=(n, k)).astype(np.float32)
    want = np.asarray(jsparse.neighbor_mean(jnp.asarray(edges),
                                            jnp.asarray(x)))
    assert _rel(tops.neighbor_mean(_t(edges), _t(x)).numpy(), want) < 1e-6
    # numpy edges, and the nodes with no in-edge stay 0 (degree clamp)
    got = tops.neighbor_mean(edges, _t(x)).numpy()
    assert _rel(got, want) < 1e-6
    assert not got[n - 10:].any()


def _levels(seed):
    """A symmetric level, a nonsymmetric one and a diagonal one."""
    r = np.random.default_rng(seed)
    A1 = sp.random(40, 40, density=0.15, random_state=seed)
    A1 = (A1 + A1.T + sp.eye(40)).tocsr()
    A2 = (sp.random(25, 25, density=0.3, random_state=seed + 1)
          + sp.eye(25)).tocsr()
    D = sp.diags(r.uniform(0.5, 2.0, 30)).tocsr()
    return [A1, A2, D]


def test_block_diag_ell_matches_jax():
    mats = _levels(0)
    t_ops = [tsparse.as_operator(A, device="cpu") for A in mats]
    j_ops = [jsparse.as_operator(A) for A in mats]
    tb, jb = tsparse.block_diag_ell(t_ops), jsparse.block_diag_ell(j_ops)
    np.testing.assert_array_equal(tb.indices.numpy(), np.asarray(jb.indices))
    np.testing.assert_array_equal(tb.values.numpy(), np.asarray(jb.values))
    assert tb.n_cols == jb.n_cols == 95
    U = np.random.default_rng(2).normal(size=(95, 6)).astype(np.float32)
    assert _rel(tops.spmm(tb, _t(U)).numpy(),
                jsparse.spmm(jb, jnp.asarray(U))) < 1e-6
    # The stored transpose is the stack of the levels' transposes: the
    # SpMM's backward pass gathers A^T g.
    assert tb.transpose_ell is not None
    dense = sp.block_diag(mats).toarray()
    Ut = _t(U).requires_grad_()
    g = np.random.default_rng(3).normal(size=(95, 6)).astype(np.float32)
    (tops.spmm(tb, Ut) * _t(g)).sum().backward()
    assert _rel(Ut.grad.numpy(), dense.T @ g) < 1e-6
    with pytest.raises(TypeError, match="block_diag_ell"):
        tsparse.block_diag_ell([tsparse.as_operator(mats[0], device="cpu"),
                                object()])


def test_simple_corrector_on_edge_index_matches_flax():
    n, f = 90, 5
    edges = _edges(n, 500, 7)
    x = np.random.default_rng(8).normal(size=(n, f)).astype(np.float32)
    jm = JSimpleCorrector((16, 16), 4)
    jp = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(edges))
    want = np.asarray(jm.apply(jp, jnp.asarray(x), jnp.asarray(edges)))
    tm = from_flax_params(SimpleCorrector(f, (16, 16), 4),
                          jax.tree_util.tree_map(np.asarray, jp))
    assert _rel(tm(_t(x), _t(edges)).detach().numpy(), want) < 1e-5
    # The operator form gives the same output.
    op = tsparse.neighbor_mean_operator(edges, n, device="cpu")
    assert _rel(tm(_t(x), op).detach().numpy(), want) < 1e-5


def _smooth_both(kind, L, M, U0, n_iters):
    """Both packages' smooth_eigenfunctions(tau=0.1) on an ELL or a
    rolling-band K (RCM order) with a Diagonal M; returns (port, JAX,
    exact solve of (M + 0.1 K) X = M U0 in fp64), in the K's order."""
    if kind == "rolling":
        tK, perm = tsparse.RollingBanded.from_scipy(L, device="cpu")
        jK, jperm = jsparse.RollingBanded.from_scipy(L)
        np.testing.assert_array_equal(perm, jperm)
    else:
        perm = np.arange(L.shape[0])
        tK = tsparse.as_operator(L, device="cpu")
        jK = jsparse.as_operator(L)
    L, M, U = L[perm][:, perm].tocsc(), M[perm][:, perm].tocsc(), U0[perm]
    t = smooth_eigenfunctions(tsparse.as_operator(M, device="cpu"), tK,
                              _t(U), tau=0.1, n_iters=n_iters).numpy()
    j = np.asarray(j_smooth(jsparse.as_operator(M), jK, jnp.asarray(U),
                            tau=0.1, n_iters=n_iters))
    exact = spsolve(M + 0.1 * L, M @ U.astype(np.float64))
    return t, j, exact


@pytest.mark.parametrize("kind", ["ell", "rolling"])
def test_smooth_eigenfunctions_matches_jax(sphere, kind):
    """Held to rel 1e-4 at 10 CG iterations. At the default 30 the
    iterate is chaotic in both packages: the first modes' residuals have
    converged, the Krylov basis degenerates, and a 1e-14 relative change
    of U0 moves the fp64 iterate by 8e-5; two fp32 summation orders
    part by 1e-4..2.5e-3. There each package is held to the exact solve
    instead: the port's distance at most twice the JAX package's."""
    L, M, U0 = sphere
    t, j, _ = _smooth_both(kind, L, M, U0, 10)
    assert _rel(t, j) < 1e-4
    t, j, exact = _smooth_both(kind, L, M, U0, 30)
    assert np.isfinite(t).all()
    assert _rel(t, exact) < 2 * _rel(j, exact)


def test_m_orthonormalize_cholesky_matches_jax(sphere):
    L, M, U0 = sphere
    got = m_orthonormalize_cholesky(_t(U0),
                                    tsparse.as_operator(M, device="cpu"))
    want = np.asarray(j_m_orth(jnp.asarray(U0), jsparse.as_operator(M)))
    assert _rel(got.numpy(), want) < 1e-5
    G = got.double().numpy().T @ (M @ got.double().numpy())
    assert np.abs(G - np.eye(6)).max() < 1e-5


def test_adamw_schedule_matches_optax():
    _, j_sched = j_adamw_cosine_restarts(3e-3, 10, n_cycles=3)
    _, t_sched = adamw_cosine_restarts([torch.zeros(1)], 3e-3, 10,
                                       n_cycles=3)
    steps = np.arange(0, 10 + 20 + 40 + 5)     # three cycles and past
    want = np.asarray([j_sched(jnp.int32(s)) for s in steps])
    got = np.asarray([t_sched(int(s)) for s in steps])
    assert _rel(got, want) < 1e-6
    assert got[0] == got[10] == got[30] == np.float32(3e-3)  # restarts


@pytest.mark.parametrize("grad_clip", [0.5, 0.0])
def test_adamw_updates_match_optax(grad_clip):
    r = np.random.default_rng(5)
    shapes = [(6, 4), (4,), (3, 2)]
    p0 = [r.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[r.normal(size=s).astype(np.float32) for s in shapes]
             for _ in range(50)]
    kw = dict(weight_decay=1e-2, grad_clip=grad_clip, n_cycles=3)
    j_opt, _ = j_adamw_cosine_restarts(1e-2, 10, **kw)
    jp = [jnp.asarray(p) for p in p0]
    state = j_opt.init(jp)
    params = [_t(p.copy()).requires_grad_() for p in p0]
    t_opt, _ = adamw_cosine_restarts(params, 1e-2, 10, **kw)
    clipped = 0
    for g in grads:                 # crosses the restarts at 10 and 30
        upd, state = j_opt.update([jnp.asarray(x) for x in g], state, jp)
        jp = optax.apply_updates(jp, upd)
        for p, x in zip(params, g):
            p.grad = _t(x)
        t_opt.step()
        clipped += bool(grad_clip) and (
            np.sqrt(sum((x ** 2).sum() for x in g)) > grad_clip)
        for p, j in zip(params, jp):
            assert _rel(p.detach().numpy(), j) < 1e-6
    # With the clip on, every update is clipped (global norms ~5 > 0.5).
    assert clipped == (50 if grad_clip else 0)


def test_tufted_cover_matches_jax():
    x = np.random.default_rng(0).normal(size=(300, 3))
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    Lt, Mt = point_cloud_laplacian(x, use_native=False, cover="tufted")
    jL, jM = j_pcl(x, use_native=False, cover="tufted")
    assert abs(Lt - jL).max() < 1e-12
    assert abs(Mt - jM).max() < 1e-12
    Lp, Mp = point_cloud_laplacian(x, use_native=False, cover="paired")
    assert abs(Lt - Lt.T).max() < 1e-10
    assert np.abs(Lt @ np.ones(300)).max() < 1e-9
    assert Mt.diagonal().min() > 0
    assert np.isclose(Mt.sum(), Mp.sum(), rtol=0.05)
    vp = eigsh(Lp, k=6, M=Mp, sigma=-0.01, which="LM")[0]
    vt = eigsh(Lt, k=6, M=Mt, sigma=-0.01, which="LM")[0]
    assert np.abs((vt[1:] - vp[1:]) / vp[1:]).max() < 0.05, (vt, vp)
    with pytest.raises(ValueError, match="cover"):
        point_cloud_laplacian(x, cover="triple")
