"""Parity of the port's split operator and orderings with the JAX package.

The same numpy clouds and scipy Laplacians go through
`eigenpinns_tpu.sparse.split` and `eigenpinns_torch.sparse.split`. Both
packages take their numpy host path (farthest-point sampling by the
numpy loop), and in the `native` cases both take their compiled one.
Tolerances:

  * `hilbert_order`, `spatial_cluster_order`, `voxel_levels` and the
    SplitBanded layout (perm, starts, core band byte for byte, remainder,
    remainder share, diagonal): equal;
  * `split_spmm` / `split_spmm_gram` with an fp32 core: rel 1e-5 against
    JAX, the U-gradients rel 1e-5; with a bf16 core the JAX CPU path
    multiplies by the unrounded U (ROADMAP F10) while the port rounds U
    as the Pallas kernels do: rel 2e-2;
  * the core's nonzero table, which K4's row-wise route reads: its
    plain reader against the core's plain product (rel 1e-6) and the
    JAX core's reference (fp32, rel 1e-6) or Pallas kernel in interpret
    mode (bf16, rel 1e-5); the bf16 core's table is the fp32 core's with
    its values rounded.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu.geometry import native as j_native
from eigenpinns_tpu.sampling.samplers import voxel_levels as j_voxel_levels
from eigenpinns_tpu.sparse import split as jsplit
from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.geometry import native as t_native
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.sampling import voxel_levels
from eigenpinns_torch.sparse import split as tsplit

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


_NATIVE = {j_native: j_native.available, t_native: t_native.available}


@pytest.fixture(autouse=True)
def _jax_numpy_host_path(monkeypatch):
    for module in _NATIVE:
        monkeypatch.setattr(module, "available", lambda: False)


def _native_host_path(monkeypatch):
    """Both packages on their compiled host kernels (skips when one of
    the libraries did not build)."""
    for module, available in _NATIVE.items():
        monkeypatch.setattr(module, "available", available)
        if not available():
            pytest.skip("a native geometry library did not build")


@pytest.fixture(scope="module")
def cloud():
    r = np.random.default_rng(20240818)
    X = r.normal(size=(900, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    X *= (1.0 + 0.3 * X[:, :1] * X[:, 1:2])
    L, M = point_cloud_laplacian(X, n_neighbors=12)
    return X, L.tocsr(), np.asarray(M.diagonal())


def test_hilbert_order_matches_jax(cloud):
    X = cloud[0]
    perm = tsplit.hilbert_order(X)
    np.testing.assert_array_equal(perm, jsplit.hilbert_order(X))
    assert sorted(perm.tolist()) == list(range(X.shape[0]))
    np.testing.assert_array_equal(tsplit.hilbert_order(np.ones((5, 3))),
                                  np.arange(5))


@pytest.mark.parametrize("with_adjacency", [False, True])
def test_spatial_cluster_order_matches_jax(cloud, with_adjacency):
    X, L, _ = cloud
    adj = L if with_adjacency else None
    perm = tsplit.spatial_cluster_order(X, 6, adjacency=adj)
    np.testing.assert_array_equal(
        perm, jsplit.spatial_cluster_order(X, 6, adjacency=adj))
    assert sorted(perm.tolist()) == list(range(X.shape[0]))


@pytest.mark.parametrize("with_adjacency", [False, True])
def test_spatial_cluster_order_matches_jax_native(cloud, with_adjacency,
                                                  monkeypatch):
    _native_host_path(monkeypatch)
    test_spatial_cluster_order_matches_jax(cloud, with_adjacency)


def test_split_layout_matches_jax_native(cloud, monkeypatch):
    """The cluster-ordered layout with both packages' compiled FPS."""
    _native_host_path(monkeypatch)
    test_split_layout_matches_jax({"cluster": _build(cloud, "cluster")},
                                  "cluster")


# case -> from_scipy keyword arguments (besides X)
CASES = {
    "cluster": dict(window=256, n_clusters=6),
    "cluster_auto": dict(window=128),
    "hilbert": dict(window=128, order="hilbert"),
    "explicit": dict(window=128, order="explicit"),
    "rcm": dict(window=256, no_x=True),
    "hilbert_bf16": dict(window=128, order="hilbert", bf16=True),
}


def _build(cloud, case):
    X, L, _ = cloud
    kw = dict(CASES[case])
    bf16 = kw.pop("bf16", False)
    no_x = kw.pop("no_x", False)
    if kw.get("order") == "explicit":
        kw["order"] = tsplit.hilbert_order(X)
    jkw = dict(kw, dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tkw = dict(kw, dtype=torch.bfloat16 if bf16 else torch.float32,
               device="cpu")
    Xa = None if no_x else X
    jop, jperm = jsplit.SplitBanded.from_scipy(L, X=Xa, **jkw)
    top, tperm = tsplit.SplitBanded.from_scipy(L, X=Xa, **tkw)
    return jop, jperm, top, tperm


@pytest.fixture(scope="module")
def ops(cloud):
    with pytest.MonkeyPatch.context() as mp:
        for module in _NATIVE:
            mp.setattr(module, "available", lambda: False)
        return {case: _build(cloud, case) for case in CASES}


@pytest.mark.parametrize("case", list(CASES))
def test_split_layout_matches_jax(ops, case):
    jop, jperm, top, tperm = ops[case]
    np.testing.assert_array_equal(jperm, tperm)
    jc, tc = jop.core, top.core
    assert (tc.n, tc.n_cols, tc.tile, tc.bandwidth) == (
        jc.n, jc.n_cols, jc.tile, jc.bandwidth)
    assert tc.transpose_banded is None and jc.transpose_banded is None
    np.testing.assert_array_equal(tc.starts.numpy(), np.asarray(jc.starts))
    if case.endswith("bf16"):
        assert tc.band.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tc.band.view(torch.int16).numpy(),
            np.asarray(jc.band).view(np.int16))
    else:
        np.testing.assert_array_equal(tc.band.numpy(), np.asarray(jc.band))
    assert (top.remainder is None) == (jop.remainder is None)
    if jop.remainder is not None:
        # fp32 even for a bf16 core
        assert top.remainder.values.dtype == torch.float32
        np.testing.assert_array_equal(top.remainder.indices.numpy(),
                                      np.asarray(jop.remainder.indices))
        np.testing.assert_array_equal(top.remainder.values.numpy(),
                                      np.asarray(jop.remainder.values))
    assert top.remainder_nnz_fraction == jop.remainder_nnz_fraction
    np.testing.assert_array_equal(top.diagonal().numpy(),
                                  np.asarray(jop.diagonal()))
    assert top.shape == jop.shape and top.n == jop.n


def test_split_hilbert_reproduces_the_operator(ops, cloud):
    """Core + remainder = P A P^T exactly (fp32), and the Hilbert core
    keeps most of the nnz at window 128."""
    _, L, _ = cloud
    _, _, top, perm = ops["hilbert"]
    _, _, top_e, perm_e = ops["explicit"]
    np.testing.assert_array_equal(perm, perm_e)
    U = np.random.default_rng(1).normal(size=(top.n, 5)).astype(np.float32)
    ref = L[perm][:, perm] @ U.astype(np.float64)
    out = tsparse.spmm(top, torch.from_numpy(U)).numpy()
    assert _rel(out, ref) < 1e-5
    np.testing.assert_array_equal(
        out, tsparse.spmm(top_e, torch.from_numpy(U)).numpy())
    assert top.remainder_nnz_fraction < 0.5


def test_split_error_paths(cloud):
    X, L, _ = cloud
    with pytest.raises(ValueError, match="unknown order"):
        tsplit.SplitBanded.from_scipy(L, X=X, order="zorder", device="cpu")
    with pytest.raises(ValueError, match="explicit order"):
        tsplit.SplitBanded.from_scipy(L, X=X, order=np.arange(10),
                                      device="cpu")
    A = sp.random(200, 200, density=0.05, random_state=3, format="csr")
    with pytest.raises(ValueError, match="numerically symmetric"):
        tsplit.SplitBanded.from_scipy(A + sp.eye(200), device="cpu")


@pytest.mark.parametrize("case", ["cluster", "hilbert", "rcm",
                                  "hilbert_bf16"])
def test_split_spmm_and_gram_match_jax(ops, case):
    """split_spmm and split_spmm_gram (through the spmm / spmm_gram
    dispatch) and their U-gradients against jax.grad."""
    import eigenpinns_tpu.sparse as jsparse

    jop, _, top, _ = ops[case]
    r = np.random.default_rng(4)
    U = r.normal(size=(top.n, 7)).astype(np.float32)
    Uj = jnp.asarray(U)
    tol = 2e-2 if case.endswith("bf16") else 1e-5

    def jf(u):
        W, G = jsparse.spmm_gram(jop, u)
        return (jnp.sum(jnp.sin(jsparse.spmm(jop, u))) + jnp.sum(W**2)
                + jnp.sum(G**2))

    Wj, Gj = jsplit.split_spmm_gram(jop, Uj)
    Ut = torch.from_numpy(U).requires_grad_(True)
    W, G = tsparse.spmm_gram(top, Ut)
    S = tsplit.split_spmm(top, Ut)
    assert _rel(S.detach().numpy(), jsplit.split_spmm(jop, Uj)) < tol
    assert _rel(W.detach().numpy(), Wj) < tol
    assert _rel(G.detach().numpy(), Gj) < tol
    (torch.sin(tsparse.spmm(top, Ut)).sum() + (W**2).sum()
     + (G**2).sum()).backward()
    assert _rel(Ut.grad.numpy(), jax.grad(jf)(Uj)) < tol


@pytest.mark.parametrize("case", list(CASES))
def test_split_core_carries_its_table(ops, case):
    """The core's nonzero table (`BandedELL.narrow`, in the core's type),
    which K4's row-wise route reads, is the table of its band, and its
    plain reader matches the core's plain product (rel 1e-6) and the JAX
    core's: the reference in fp32 (rel 1e-6), the Pallas kernel in
    interpret mode in bf16, where both round U (rel 1e-5)."""
    from eigenpinns_tpu.sparse import banded as jbanded
    from eigenpinns_torch.sparse.banded import banded_spmm_plain
    from eigenpinns_torch.sparse.nonzeros import band_table, table_spmm_plain

    jop, _, top, _ = ops[case]
    core, t = top.core, top.core.narrow
    fresh = band_table(core.band, core.occupancy, core.starts)
    assert t.val.dtype == core.band.dtype
    for a, b in ((t.val, fresh.val), (t.idx, fresh.idx),
                 (t.slice_start, fresh.slice_start)):
        assert torch.equal(a, b)
    U = np.random.default_rng(6).normal(size=(core.n, 20)).astype(np.float32)
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    W = table_spmm_plain(t, Ut, core.n).numpy()
    assert _rel(W, banded_spmm_plain(core, Ut).numpy()) < 1e-6
    if case.endswith("bf16"):
        ref, tol = jbanded.banded_spmm_pallas(jop.core, Uj,
                                              interpret=True), 1e-5
    else:
        ref, tol = jbanded.banded_spmm_reference(jop.core, Uj), 1e-6
    assert _rel(W, ref) < tol


def test_split_bf16_core_table_is_the_fp32_table_rounded(ops):
    """The bf16 core's table, built from its own band, lists the fp32
    core's nonzeros (none rounds to 0 here) with their values rounded to
    nearest even: the same U rows and slices."""
    _, _, t32, _ = ops["hilbert"]
    _, _, t16, _ = ops["hilbert_bf16"]
    a, b = t32.core.narrow, t16.core.narrow
    assert b.val.dtype == torch.bfloat16
    assert torch.equal(a.idx, b.idx)
    assert torch.equal(a.slice_start, b.slice_start)
    assert torch.equal(a.val.bfloat16(), b.val)
    assert torch.equal(a.with_values(torch.bfloat16).val, b.val)


@pytest.mark.parametrize("targets", [[100, 300], [50], [5000]])
def test_voxel_levels_match_jax(cloud, targets):
    X = cloud[0]
    t = voxel_levels(X, targets)
    j = j_voxel_levels(X, targets)
    assert len(t) == len(j) == len(targets) + 1
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(t[-1], np.arange(X.shape[0]))
