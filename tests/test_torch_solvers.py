"""Parity of the port's solvers with the JAX package on the same inputs.

Operators: the point-cloud Laplacian of a 642-vertex perturbed icosphere
as a rolling band (RCM order) with its lumped mass, and a 64-point FPS
coarse level with its prolongation. Tolerances: eigenvalues and the
smoothed/corrected blocks to rel 1e-4 (fp32 iterations whose rounding
differs between the frameworks); converged LOBPCG eigenvalues to rel
1e-4 against eigsh.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.sparse import diags as sp_diags

from eigenpinns_tpu import solvers as jsolvers
from eigenpinns_tpu import sparse as jsparse
from eigenpinns_torch import solvers as tsolvers
from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.sampling import farthest_point_levels, prolongation_matrix
from eigenpinns_torch.solvers.oracle import eigsh_smallest
from eigenpinns_torch.utils.fixtures import perturbed_icosphere


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.fixture(scope="module")
def problem():
    X = perturbed_icosphere(3).verts
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    tK, perm = tsparse.RollingBanded.from_scipy(L)
    jK, _ = jsparse.RollingBanded.from_scipy(L)
    L, M, X = L[perm][:, perm].tocsr(), M[perm][:, perm].tocsr(), X[perm]
    coarse = X[farthest_point_levels(X, [64])[0]]
    Lc, Mc = point_cloud_laplacian(coarse, n_neighbors=15)
    P = prolongation_matrix(coarse, X, 21).tocsr()
    vals, vecs = eigsh_smallest(L, M, 8)
    _, vc = eigsh_smallest(Lc, Mc, 6)
    U = (P @ vc).astype(np.float32)      # a prolongated coarse guess
    ops = {}
    for pkg, ns, K in (("t", tsparse, tK), ("j", jsparse, jK)):
        Kc = (tsparse.RollingBanded if pkg == "t" else
              jsparse.RollingBanded).from_scipy(Lc, reorder=False)[0]
        ops[pkg] = dict(K=K, M=ns.as_operator(M), Kc=Kc,
                        P=ns.as_operator(P), Pt=ns.as_operator(P.T.tocsr()))
    return dict(L=L, M=M, vals=vals, vecs=vecs, U=U, ops=ops)


def _args(problem, pkg, names):
    return [problem["ops"][pkg][n] for n in names]


def test_rayleigh_ritz_family_matches_jax(problem):
    U = problem["U"]
    t, j = problem["ops"]["t"], problem["ops"]["j"]
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    w, V = tsolvers.rayleigh_ritz(Ut, t["K"], t["M"])
    wj, _ = jsolvers.rayleigh_ritz(Uj, j["K"], j["M"])
    assert _rel(w.numpy(), wj) < 1e-4
    G = tsparse.m_gram(V, t["M"]).numpy()
    assert np.abs(G - np.eye(6)).max() < 1e-4
    # A dependent column: the robust variant filters it to the end.
    Ud = np.concatenate([U, U[:, :1]], axis=1)
    wr, Vr = tsolvers.rayleigh_ritz_robust(torch.from_numpy(Ud), t["K"],
                                           t["M"])
    wrj, _ = jsolvers.rayleigh_ritz_robust(jnp.asarray(Ud), j["K"], j["M"])
    assert _rel(wr.numpy()[:6], np.asarray(wrj)[:6]) < 1e-4
    assert wr[6] > wr[:6].max()
    A = np.diag(np.arange(1.0, 5.0)).astype(np.float32)
    B = (np.eye(4) * 2.0).astype(np.float32)
    we, _ = tsolvers.eigh_generalized(torch.from_numpy(A), torch.from_numpy(B))
    np.testing.assert_allclose(we.numpy(), np.arange(1.0, 5.0) / 2.0,
                               rtol=1e-6)


def test_smoothers_and_cgc_match_jax(problem):
    U = problem["U"]
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    K, M = _args(problem, "t", ["K", "M"])
    Kj, Mj = _args(problem, "j", ["K", "M"])
    Us = tsolvers.jacobi_smooth(M, K, Ut, alpha=0.1, n_iters=10)
    Usj = jsolvers.jacobi_smooth(Mj, Kj, Uj, alpha=0.1, n_iters=10)
    assert _rel(Us.numpy(), Usj) < 1e-5
    X = tsolvers.cg_solve(K, Ut, n_iters=30, ridge=1e-2)
    Xj = jsolvers.cg_solve(Kj, Uj, n_iters=30, ridge=1e-2)
    assert _rel(X.numpy(), Xj) < 1e-4
    t = _args(problem, "t", ["K", "M", "Kc", "P", "Pt"])
    j = _args(problem, "j", ["K", "M", "Kc", "P", "Pt"])
    # A ridge of 1e-2: at the default 1e-6 the coarse solve amplifies the
    # residual's constant-mode component ~1e6 and fp32 CG round-off with it.
    Uc, lam = tsolvers.coarse_grid_correction(Ut, *t, ridge=1e-2)
    Ucj, lamj = jsolvers.coarse_grid_correction(Uj, *j, ridge=1e-2)
    assert _rel(lam.numpy(), lamj) < 1e-4
    assert _rel(Uc.numpy(), Ucj) < 1e-4


def test_lobpcg_matches_jax_and_eigsh(problem):
    rng = np.random.default_rng(0)
    X0 = (problem["vecs"][:, :8] + 0.05 * rng.normal(
        size=(len(problem["U"]), 8))).astype(np.float32)
    K, M = _args(problem, "t", ["K", "M"])
    Kj, Mj = _args(problem, "j", ["K", "M"])
    res = tsolvers.lobpcg(K, M, torch.from_numpy(X0), max_iter=60, tol=1e-6)
    resj = jsolvers.lobpcg(Kj, Mj, jnp.asarray(X0), max_iter=60, tol=1e-6)
    vals = problem["vals"]
    assert _rel(res.eigenvalues.numpy()[1:], np.asarray(resj.eigenvalues)[1:]
                ) < 1e-4
    assert _rel(res.eigenvalues.numpy()[1:], vals[1:]) < 1e-4
    assert int(res.iterations) <= 60
    G = tsparse.m_gram(res.eigenvectors, M).numpy()
    assert np.abs(G - np.eye(8)).max() < 1e-3


def test_lobpcg_recovers_from_rank_deficient_warm_start(problem):
    """Zero columns in X0 (a collapsed learned subspace) are replaced by
    search directions instead of coming back as spurious 0 eigenvalues."""
    rng = np.random.default_rng(1)
    X0 = problem["vecs"][:, :8].copy()
    X0[:, 3:6] = 0.0
    X0 = np.concatenate([X0, rng.normal(size=(len(X0), 3))], axis=1)
    K, M = _args(problem, "t", ["K", "M"])
    res = tsolvers.lobpcg(K, M, torch.from_numpy(X0.astype(np.float32)),
                          max_iter=100, tol=1e-7)
    vals = problem["vals"]
    lam = res.eigenvalues.numpy()[:8]
    assert abs(lam[0]) < 1e-4
    assert _rel(lam[1:], vals[1:]) < 1e-4


def test_lobpcg_from_random_is_seeded(problem):
    K, M = _args(problem, "t", ["K", "M"])
    a = tsolvers.lobpcg_from_random(
        K, M, 5, generator=torch.Generator().manual_seed(3), max_iter=200,
        tol=1e-5)
    b = tsolvers.lobpcg_from_random(
        K, M, 5, generator=torch.Generator().manual_seed(3), max_iter=200,
        tol=1e-5)
    assert torch.equal(a.eigenvalues, b.eigenvalues)
    assert _rel(a.eigenvalues.numpy()[1:], problem["vals"][1:5]) < 1e-3


def test_lobpcg_fp32_converges_past_the_gram_eigenvalue_floor():
    """F9: on a 6000-point cloud (largest eigenvalue ~1e6 times the
    wanted ones), steering the residual by the Rayleigh quotients of X
    reaches rel 2e-5 of eigsh in 200 fp32 iterations; the JAX iteration,
    which steers by the eigenvalues of the fp32 Gram S^T K S, stalls
    above 5e-5 (1.7e-4 when measured) from the same start."""
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from eigenpinns_torch.utils.fixtures import make_cloud

    X = make_cloud(6000)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    perm = np.asarray(reverse_cuthill_mckee(L.tocsr(), symmetric_mode=True))
    L, m, X = L.tocsr()[perm][:, perm], np.asarray(M.diagonal())[perm], X[perm]
    vals, _ = eigsh_smallest(L, sp_diags(m), 20)
    x, y, z = X.T
    feats = np.stack([np.ones_like(x), x, y, z, x * x, y * y, z * z, x * y,
                      x * z, y * z, x**3, y**3, z**3, x * x * y, x * x * z,
                      y * y * x, y * y * z, z * z * x, z * z * y, x * y * z],
                     axis=1)
    X0 = np.concatenate([feats / np.linalg.norm(feats, axis=0),
                         np.random.default_rng(3).normal(size=(6000, 8))],
                        axis=1).astype(np.float32)

    def err(lam):
        lam = np.sort(np.asarray(lam))[:20]
        return np.max(np.abs(lam[1:] - vals[1:]) / vals[1:])

    res = tsolvers.lobpcg(tsparse.SparseELL.from_scipy(L),
                          tsparse.Diagonal(torch.tensor(m,
                                                        dtype=torch.float32)),
                          torch.from_numpy(X0), max_iter=200, tol=1e-6)
    resj = jsolvers.lobpcg(jsparse.SparseELL.from_scipy(L),
                           jsparse.Diagonal(jnp.asarray(m, jnp.float32)),
                           jnp.asarray(X0), max_iter=200, tol=1e-6)
    assert err(res.eigenvalues.numpy()) < 2e-5
    assert err(resj.eigenvalues) > 5e-5
