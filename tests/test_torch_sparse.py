"""Parity of the torch port's sparse layer with the JAX package.

The same numpy inputs go through `eigenpinns_tpu.sparse` and
`eigenpinns_torch.sparse`. Tolerances: rel 1e-5 for products and Grams
(fp32 sums in another order), 1e-4 for gradients (two products deep),
2e-3 against the bf16-rounded operator in 'bf16' mode (as
tests/test_sparse.py states). The CUDA kernel itself is checked against
its plain version by the `cuda`-marked tests of tests/test_torch_cuda.py,
which run only on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu import sparse as jsparse
from eigenpinns_tpu.geometry import point_cloud_laplacian as j_pcl
from eigenpinns_torch import sparse as tsparse

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _case(name):
    """The operators of tests/test_sparse.py:322-413: (matrix, reorder)."""
    if name == "pentadiagonal":
        n = 333
        return sp.diags([-1.0, -0.5, 2.9, -0.5, -1.0], [-2, -1, 0, 1, 2],
                        shape=(n, n)).tocsr(), True
    if name == "nonsymmetric":
        n = 260
        return sp.diags([-0.3, 2.0, -1.2], [-1, 0, 1],
                        shape=(n, n)).tocsr(), False
    r2 = np.random.default_rng(7)
    X = r2.normal(size=(500, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = j_pcl(X, n_neighbors=12)
    return L.tocsr(), True


CASES = ["pentadiagonal", "nonsymmetric", "point_cloud"]


@pytest.fixture(scope="module")
def ops():
    out = {}
    for name in CASES:
        A, reorder = _case(name)
        jop, jperm = jsparse.RollingBanded.from_scipy(A, reorder=reorder)
        top, tperm = tsparse.RollingBanded.from_scipy(A, reorder=reorder,
                                                       device="cpu")
        out[name] = (A, jop, jperm, top, tperm)
    return out


@pytest.mark.parametrize("name", CASES)
def test_rolling_layout_matches_jax(ops, name):
    """Same RCM order, band, pre, window and transpose as the JAX build."""
    _, jop, jperm, top, tperm = ops[name]
    np.testing.assert_array_equal(jperm, tperm)
    assert (top.pre, top.win, top.n, top.tile) == (jop.pre, jop.win, jop.n,
                                                   jop.tile)
    np.testing.assert_array_equal(top.band.numpy(), np.asarray(jop.band))
    assert (top.transpose_rolling is None) == (jop.transpose_rolling is None)
    if jop.transpose_rolling is not None:
        np.testing.assert_array_equal(
            top.transpose_rolling.band.numpy(),
            np.asarray(jop.transpose_rolling.band))
    np.testing.assert_allclose(top.diagonal().numpy(),
                               np.asarray(jop.diagonal()), rtol=0, atol=0)


@pytest.mark.parametrize("name", CASES)
def test_rolling_plain_matches_jax_reference_and_pallas(ops, name):
    _, jop, _, top, _ = ops[name]
    U = np.random.default_rng(1).normal(size=(top.n, 7)).astype(np.float32)
    W = tsparse.rolling_spmm_plain(top, torch.from_numpy(U)).numpy()
    Wg, G = tsparse.rolling_spmm_gram_plain(top, torch.from_numpy(U))
    Uj = jnp.asarray(U)
    W_ref = np.asarray(jsparse.rolling.rolling_spmm_reference(jop, Uj))
    W_pl = np.asarray(jsparse.rolling_spmm_pallas(jop, Uj, interpret=True))
    W_plg, G_pl = jsparse.rolling_spmm_gram_pallas(jop, Uj, interpret=True)
    assert _rel(W, W_ref) < 1e-5
    assert _rel(W, W_pl) < 1e-5
    assert _rel(Wg.numpy(), W_plg) < 1e-5
    assert _rel(G.numpy(), G_pl) < 1e-5


@pytest.mark.parametrize("name", CASES)
def test_rolling_autograd_matches_jax(ops, name):
    """d/dU [sum W^2 + sum G^2] through the fused Gram, and d/dU sum
    sin(A U) through the plain product (A^T from the stored transpose
    for the nonsymmetric case)."""
    _, jop, _, top, _ = ops[name]
    U = np.random.default_rng(2).normal(size=(top.n, 5)).astype(np.float32)

    def jf(u):
        W, G = jsparse.rolling_spmm_gram(jop, u)
        return jnp.sum(W**2) + jnp.sum(G**2)

    gj = np.asarray(jax.grad(jf)(jnp.asarray(U)))
    gj2 = np.asarray(jax.grad(
        lambda u: jnp.sum(jnp.sin(jsparse.rolling_spmm(jop, u))))(
            jnp.asarray(U)))
    Ut = torch.from_numpy(U).requires_grad_(True)
    W, G = tsparse.rolling_spmm_gram(top, Ut)
    ((W**2).sum() + (G**2).sum()).backward()
    assert _rel(Ut.grad.numpy(), gj) < 1e-4
    Ut.grad = None
    torch.sin(tsparse.rolling_spmm(top, Ut)).sum().backward()
    assert _rel(Ut.grad.numpy(), gj2) < 1e-4


def test_rolling_bf16_mode_rounds_operator_and_u():
    """'bf16' = bf16 band times bf16-rounded U, fp32 sums: within 2e-3
    of the bf16-rounded operator, like the TPU kernel."""
    import ml_dtypes

    r2 = np.random.default_rng(3)
    X = r2.normal(size=(600, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    L, _ = j_pcl(X, n_neighbors=12)
    op, p = tsparse.RollingBanded.from_scipy(L, device="cpu")
    opb = op.with_precision("bf16")
    assert opb.band.dtype == torch.bfloat16
    assert opb.with_precision("highest").band.dtype == torch.float32
    Lb = L.tocsr()[p][:, p]
    Lb.data = Lb.data.astype(ml_dtypes.bfloat16).astype(np.float64)
    U = r2.normal(size=(600, 5)).astype(np.float32)
    ref = Lb @ U.astype(np.float64)
    W = tsparse.spmm(opb, torch.from_numpy(U)).numpy()
    assert _rel(W, ref) < 2e-3


def test_rolling_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never falls back: CPU tensors are refused."""
    A, _ = _case("pentadiagonal")
    op, _ = tsparse.RollingBanded.from_scipy(A, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        tsparse.rolling_spmm_cuda(op, torch.zeros(op.n, 3))


def _ell_case():
    rng = np.random.default_rng(5)
    n = 150
    A = sp.random(n, n, density=0.05, random_state=5, format="csr")
    A = A + sp.diags(rng.uniform(1, 2, n))
    return A.tocsr()


def test_ell_spmm_and_transpose_gather_backward():
    A = _ell_case()
    jop = jsparse.SparseELL.from_scipy(A)
    top = tsparse.SparseELL.from_scipy(A, device="cpu")
    assert top.transpose_ell is not None
    np.testing.assert_array_equal(top.indices.numpy(), np.asarray(jop.indices))
    np.testing.assert_array_equal(top.values.numpy(), np.asarray(jop.values))
    U = np.random.default_rng(6).normal(size=(A.shape[0], 4)).astype(
        np.float32)
    Wj = np.asarray(jsparse.spmm(jop, jnp.asarray(U)))
    gj = np.asarray(jax.grad(lambda u: jnp.sum(jnp.sin(jsparse.spmm(
        jop, u))))(jnp.asarray(U)))
    Ut = torch.from_numpy(U).requires_grad_(True)
    Wt = tsparse.spmm(top, Ut)
    torch.sin(Wt).sum().backward()
    assert _rel(Wt.detach().numpy(), Wj) < 1e-5
    assert _rel(Ut.grad.numpy(), gj) < 1e-5
    assert _rel(Wt.detach().numpy(), A @ U.astype(np.float64)) < 1e-5
    np.testing.assert_allclose(top.diagonal().numpy(),
                               np.asarray(jop.diagonal()))
    assert abs(top.to_scipy() - A).max() < 1e-6


def test_diagonal_and_as_operator():
    M = sp.diags(np.linspace(1.0, 2.0, 40)).tocsr()
    op = tsparse.as_operator(M, device="cpu")
    assert isinstance(op, tsparse.Diagonal)
    np.testing.assert_allclose(op.diag.numpy(), M.diagonal(), rtol=1e-7)
    assert isinstance(tsparse.as_operator(_ell_case(), device="cpu"), tsparse.SparseELL)
    with pytest.raises(TypeError):
        tsparse.as_operator(np.eye(3), device="cpu")


def test_gram_reductions_match_jax():
    A = _ell_case()
    A = (A + A.T).tocsr()
    M = sp.diags(np.random.default_rng(8).uniform(0.5, 1.5, A.shape[0]))
    jK, jM = jsparse.as_operator(A), jsparse.as_operator(M.tocsr())
    tK = tsparse.as_operator(A, device="cpu")
    tM = tsparse.as_operator(M.tocsr(), device="cpu")
    U = np.random.default_rng(9).normal(size=(A.shape[0], 6)).astype(
        np.float32)
    lam = np.linspace(0.1, 1.0, 6).astype(np.float32)
    Uj, Ut = jnp.asarray(U), torch.from_numpy(U)
    pairs = [
        (tsparse.m_gram(Ut, tM), jsparse.m_gram(Uj, jM)),
        (tsparse.rayleigh_quotients(Ut, tK, tM),
         jsparse.rayleigh_quotients(Uj, jK, jM)),
        (tsparse.m_normalize_columns(Ut, tM),
         jsparse.m_normalize_columns(Uj, jM)),
        (tsparse.residual(Ut, tK, tM, torch.from_numpy(lam)),
         jsparse.residual(Uj, jK, jM, jnp.asarray(lam))),
        (tsparse.spmm_gram(tK, Ut)[1], jsparse.spmm_gram(jK, Uj)[1]),
        (tsparse.spmv(tK, Ut[:, 0]), jsparse.spmv(jK, Uj[:, 0])),
    ]
    for t, j in pairs:
        assert _rel(t.numpy(), j) < 1e-5


def test_graph_operators_match_jax():
    rng = np.random.default_rng(10)
    n = 80
    edges = np.stack([np.repeat(np.arange(n), 5),
                      rng.integers(0, n, size=5 * n)])
    for tf, jf in ((tsparse.neighbor_mean_operator,
                    jsparse.neighbor_mean_operator),
                   (tsparse.gcn_normalized_adjacency,
                    jsparse.gcn_normalized_adjacency)):
        t, j = tf(edges, n, device="cpu"), jf(edges, n)
        assert abs(t.to_scipy() - j.to_scipy()).max() < 1e-7
        assert (t.transpose_ell is None) == (j.transpose_ell is None)
