"""The port's spectral-basis slice against the JAX package and eigsh.

`lobpcg_blocked`, `spectral_basis` (both operator formats),
`spectral_basis_family` and `train_joint` on a SplitBanded K go through
both packages on the same numpy inputs; both take their numpy host path
(no compiled kNN / FPS / triangulation), and in the `native` cases both
take their compiled one (the same C++ source). The guard columns of each
blocked sweep are random (`jax.random` there, a `torch.Generator` here),
so the solvers are compared after convergence. Tolerances:

  * eigenvalues of modes 1+ against eigsh: rel 1e-3 (the JAX tests' bar);
  * against the JAX solver's eigenvalues: rel 1e-3 as well. The JAX
    fp32 iteration stalls ~2e-4 away from eigsh on these clouds (ROADMAP
    F9; the port's iteration, repaired, lands within ~1e-6), so the two
    solvers differ by the JAX error;
  * M-orthonormality across sweeps: |V^T M V - I| <= 1e-3; Rayleigh
    quotients of the returned (original-order) vectors on L: rtol 1e-3;
  * a checkpointed run resumed after an interruption: equal to an
    uninterrupted run, bit for bit;
  * `train_joint` on an fp32 SplitBanded K, with the flax parameters
    carried in: the losses rel 1e-4 epoch by epoch, the eigenvalues rel
    1e-4; with a bf16 core the JAX CPU path multiplies by the unrounded U
    (ROADMAP F10) while the port rounds U, so only the loss trajectory and
    the eigenvalues are held, to rel 2e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu.geometry import native as j_native
from eigenpinns_tpu.models import JointEigenNet as JJointEigenNet
from eigenpinns_tpu.solvers import spectral_basis as j_spectral_basis
from eigenpinns_tpu.solvers import (
    spectral_basis_family as j_spectral_basis_family,
)
from eigenpinns_tpu.solvers.direct import train_joint as j_train_joint
from eigenpinns_tpu.solvers.lobpcg import lobpcg_blocked as j_lobpcg_blocked
from eigenpinns_tpu.sparse import Diagonal as JDiagonal
from eigenpinns_tpu.sparse import SplitBanded as JSplitBanded
from eigenpinns_tpu.sparse import as_operator as j_as_operator
from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.geometry import native as t_native
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.models import JointEigenNet, from_flax_params
from eigenpinns_torch.solvers import (
    eigsh_smallest,
    family_operators,
    lobpcg_blocked,
    spectral_basis,
    spectral_basis_family,
    train_joint,
)
from eigenpinns_torch.sparse import bsr as tbsr
from eigenpinns_torch.utils.fixtures import make_cloud

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _rel_modes(vals, ref):
    """Max rel err of modes 1+ (mode 0 is the rigid-body 0)."""
    return float((np.abs(vals[1:] - ref[1:]) / np.abs(ref[1:])).max())


_NATIVE = {j_native: j_native.available, t_native: t_native.available}


def _native_host_path(monkeypatch):
    """Both packages on their compiled host kernels (skips when one of
    the libraries did not build)."""
    for module, available in _NATIVE.items():
        monkeypatch.setattr(module, "available", available)
        if not available():
            pytest.skip("a native geometry library did not build")


@pytest.fixture(autouse=True)
def _jax_numpy_host_path(monkeypatch):
    for module in _NATIVE:
        monkeypatch.setattr(module, "available", lambda: False)
    monkeypatch.setenv("EIGENPINNS_NO_WARMUP", "1")
    monkeypatch.setenv("EIGENPINNS_NO_COMPILE_CACHE", "1")


@pytest.fixture(scope="module")
def cloud1500():
    """The 1500-point cloud of tests/test_solvers.py:214-237."""
    r2 = np.random.default_rng(7)
    X = r2.normal(size=(1500, 3))
    X /= np.linalg.norm(X, axis=1, keepdims=True)
    # The numpy triangulation, which `spectral_basis` builds from X under
    # the autouse numpy host path.
    L, M = point_cloud_laplacian(X, n_neighbors=14, use_native=False)
    vals, _ = eigsh_smallest(L, M, 10)
    return X, L.tocsr(), M.tocsr(), vals


@pytest.mark.parametrize("fmt", ["ell", "split"])
def test_lobpcg_blocked_matches_jax_and_eigsh(cloud1500, fmt):
    X, L, M, vals_ref = cloud1500
    kw = dict(k_total=10, block=4, guard=2, max_iter=400, tol=1e-7)
    if fmt == "ell":
        jK, jM = j_as_operator(L), j_as_operator(M)
        tK = tsparse.as_operator(L, device="cpu")
        tM = tsparse.as_operator(M, device="cpu")
    else:
        jK, perm = JSplitBanded.from_scipy(L, X=X, window=256,
                                           order="hilbert")
        tK, _ = tsparse.SplitBanded.from_scipy(L, X=X, window=256,
                                               order="hilbert", device="cpu")
        m = np.asarray(M.diagonal())[perm]
        jM = JDiagonal(jnp.asarray(m, jnp.float32))
        tM = tsparse.Diagonal(torch.as_tensor(m, dtype=torch.float32))
        M = sp.diags(m).tocsr()
    vals, vecs, res = lobpcg_blocked(tK, tM, **kw)
    jvals, _, _ = j_lobpcg_blocked(jK, jM, **kw)
    assert vals.shape == (10,) and vecs.shape == (1500, 10)
    assert res.shape == (10,) and np.isfinite(res).all()
    assert np.all(np.diff(vals) > -1e-5)
    assert _rel_modes(vals, vals_ref) < 1e-3
    assert _rel_modes(vals, jvals) < 1e-3
    G = vecs.T.astype(np.float64) @ (M @ vecs.astype(np.float64))
    assert np.abs(G - np.eye(10)).max() < 1e-3


def test_lobpcg_blocked_checkpoint_resume(cloud1500, tmp_path):
    """An interrupted checkpointed run resumes from its last converged
    sweep (generator state included) and returns exactly what an
    uninterrupted run returns; a checkpoint of other settings is ignored
    with a warning; a finished run leaves no checkpoint behind."""
    _, L, M, _ = cloud1500
    K = tsparse.as_operator(L, device="cpu")
    Mo = tsparse.as_operator(M, device="cpu")
    kw = dict(k_total=8, block=4, guard=2, max_iter=60, tol=1e-5)
    ref = lobpcg_blocked(K, Mo, **kw)

    class Interrupt(Exception):
        pass

    def stop_at_second_sweep(b0, keep, res):
        if b0 == 4:
            raise Interrupt

    d = str(tmp_path)
    with pytest.raises(Interrupt):
        lobpcg_blocked(K, Mo, checkpoint_dir=d, log_fn=stop_at_second_sweep,
                       **kw)
    saved = np.load(tmp_path / "lobpcg_blocked.npz")
    assert int(saved["b0"]) == 4
    seen = []
    out = lobpcg_blocked(K, Mo, checkpoint_dir=d,
                         log_fn=lambda b0, keep, r: seen.append(b0), **kw)
    assert seen == [4]                         # only the second sweep ran
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    assert not (tmp_path / "lobpcg_blocked.npz").exists()

    with pytest.raises(Interrupt):
        lobpcg_blocked(K, Mo, checkpoint_dir=d, log_fn=stop_at_second_sweep,
                       **kw)
    with pytest.warns(UserWarning, match="ignoring checkpoint"):
        out2 = lobpcg_blocked(K, Mo, checkpoint_dir=d,
                              **dict(kw, tol=2e-5))
    assert out2[0].shape == (8,)


SB = dict(k=8, n_neighbors=14, coarse_n=400, window=512, block=4, guard=2,
          max_iter=300, tol=1e-6, log_fn=None)


@pytest.mark.parametrize("fmt", ["split", "bsr"])
def test_spectral_basis_matches_jax_and_eigsh(cloud1500, fmt):
    """Cloud -> warm start -> operator -> blocked LOBPCG, eigenvectors in
    the ORIGINAL point order; the JAX driver on the same operators."""
    X, L, M, vals_ref = cloud1500
    m = np.asarray(M.diagonal())
    kw = dict(SB, operator_format=fmt)
    res = spectral_basis(X, operators=(L, m), device="cpu", **kw)
    jres = j_spectral_basis(X, operators=(L, m), **kw)
    assert set(res.timings) == {"laplacian_s", "warm_start_s", "operator_s",
                                "solve_s"}
    assert res.eigenvectors.shape == (1500, 8)
    assert _rel_modes(res.eigenvalues, vals_ref[:8]) < 1e-3
    assert _rel_modes(res.eigenvalues, jres.eigenvalues) < 1e-3
    U = res.eigenvectors.astype(np.float64)
    num = np.sum(U * (L @ U), axis=0)
    den = np.sum(U * (M @ U), axis=0)
    assert np.allclose(num / den, res.eigenvalues, rtol=1e-3, atol=1e-4)
    assert np.abs(U.T @ (M @ U) - np.eye(8)).max() < 1e-3


def test_spectral_basis_matches_jax_native(cloud1500, monkeypatch):
    """The same with both warm starts on the compiled host kernels."""
    _native_host_path(monkeypatch)
    test_spectral_basis_matches_jax_and_eigsh(cloud1500, "split")


def test_spectral_basis_builds_its_laplacian_and_guards_options(cloud1500):
    X, _, _, vals_ref = cloud1500
    res = spectral_basis(X, operator_format="bsr",
                         operator_precision="high", device="cpu",
                         **dict(SB, k=6))
    assert _rel_modes(res.eigenvalues, vals_ref[:6]) < 1e-3
    # The sharded path runs on an initialized process group only
    # (tests/test_torch_sharded.py runs it on gloo ranks).
    with pytest.raises(RuntimeError, match="initialized"):
        spectral_basis(X, n_devices=2, device="cpu")
    with pytest.raises(TypeError, match="Mesh"):
        spectral_basis(X, mesh=object(), device="cpu")
    with pytest.raises(ValueError, match="operator_format"):
        spectral_basis(X, operator_format="banded", device="cpu")


def test_spectral_basis_family_matches_eigsh(monkeypatch):
    """Three clouds padded to one strip-BSR shape without group tables
    (the K3 route): each member against its own eigsh and against the
    JAX family driver."""
    X_list = []
    for f in range(3):
        r2 = np.random.default_rng(30 + f)
        X = r2.normal(size=(900 + 150 * f, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        X_list.append(X * (1.0 + 0.2 * f))
    seen = []
    plain = tbsr.bsr_spmm_plain

    def recording_plain(A, U):
        seen.append((A.gcid is None, A.n))
        return plain(A, U)

    monkeypatch.setattr(tbsr, "bsr_spmm_plain", recording_plain)
    kw = dict(k=6, n_neighbors=14, coarse_n=400, block=3, guard=2,
              max_iter=300, tol=1e-6, log_fn=None)
    results = spectral_basis_family(X_list, device="cpu", **kw)
    jresults = j_spectral_basis_family(X_list, **kw)
    assert seen and all(no_groups for no_groups, _ in seen)
    assert {n for _, n in seen} == {1280}      # one padded shape
    for X, res, jres in zip(X_list, results, jresults):
        L, M = point_cloud_laplacian(X, n_neighbors=14)
        vals_ref, _ = eigsh_smallest(L, M, 6)
        assert res.eigenvectors.shape == (X.shape[0], 6)
        assert _rel_modes(res.eigenvalues, vals_ref) < 1e-3
        assert _rel_modes(res.eigenvalues, jres.eigenvalues) < 1e-3
        U = res.eigenvectors.astype(np.float64)
        num = np.sum(U * (L @ U), axis=0)
        den = np.sum(U * (M @ U), axis=0)
        assert np.allclose(num / den, res.eigenvalues, rtol=1e-3, atol=1e-4)


def test_spectral_basis_family_matches_eigsh_native(monkeypatch):
    """The same with both packages' Laplacians and warm starts on the
    compiled host kernels."""
    _native_host_path(monkeypatch)
    test_spectral_basis_family_matches_eigsh(monkeypatch)


def test_family_operators_pad_to_one_shape():
    """Every member of `family_operators` has the family's (rows, chunks)
    shape and no group tables; on its real rows it is the member's
    Laplacian in its own order, and its pad rows and chunks add zeros."""
    Ls = []
    for f in range(3):
        r2 = np.random.default_rng(40 + f)
        X = r2.normal(size=(700 + 200 * f, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        Ls.append(point_cloud_laplacian(X, n_neighbors=12)[0].tocsr())
    ops = family_operators(Ls, device="cpu")
    assert {(op.n, op.n_chunks) for op, _ in ops} == {
        (1152, max(op.n_chunks for op, _ in ops))}
    for (op, perm), L in zip(ops, Ls):
        assert op.gcid is None
        n = L.shape[0]
        U = np.random.default_rng(n).normal(size=(op.n, 7))
        W = tbsr.bsr_spmm_plain(op, torch.as_tensor(U, dtype=torch.float32))
        ref = L[perm][:, perm] @ U[:n]
        assert _rel(W[:n].numpy(), ref) < 1e-6
        assert not W[n:].any()


TRAIN = dict(n_modes=5, hidden=(32, 32), epochs=30, scan_chunk=15,
             w_res=1.0, w_orth=10.0, w_trace=0.05, lr_start=1e-2,
             lr_end=1e-3, seed=0, mode="penalty", loss_mxu_precision="bf16",
             rayleigh_ritz_finish=True)


@pytest.mark.parametrize("core", ["f32", "bf16"])
def test_train_joint_on_split_matches_jax(core):
    """train_joint on a Hilbert-ordered SplitBanded K (the training
    operator of the spectral slice: fused Gram on the core, its backward
    pass through the core) against the JAX trainer, epoch by epoch.
    `loss_mxu_precision` leaves a SplitBanded alone in both packages."""
    X = make_cloud(642, seed=1)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    bf16 = core == "bf16"
    jK, perm = JSplitBanded.from_scipy(
        L, X=X, window=128, order="hilbert",
        dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tK, tperm = tsparse.SplitBanded.from_scipy(
        L, X=X, window=128, order="hilbert", device="cpu",
        dtype=torch.bfloat16 if bf16 else torch.float32)
    np.testing.assert_array_equal(perm, tperm)
    assert tK.remainder is not None
    m = np.asarray(M.diagonal())[perm]
    Xp = X[perm]
    jres = j_train_joint(jK, JDiagonal(jnp.asarray(m, jnp.float32)), Xp,
                         **TRAIN)
    jparams = JJointEigenNet(TRAIN["hidden"], TRAIN["n_modes"]).init(
        jax.random.PRNGKey(TRAIN["seed"]), jnp.asarray(Xp, jnp.float32))
    net = from_flax_params(JointEigenNet(3, TRAIN["hidden"],
                                         TRAIN["n_modes"]),
                           jax.tree_util.tree_map(np.asarray, jparams))
    res = train_joint(tK, tsparse.Diagonal(torch.as_tensor(
        m, dtype=torch.float32)), Xp, init_params=net.state_dict(), **TRAIN)
    tol = 2e-3 if bf16 else 1e-4
    assert res.epochs_run == jres.epochs_run == 30
    for key in ("loss",) if bf16 else ("loss", "res", "orth", "lam_mean"):
        assert _rel(res.history[key], jres.history[key]) < tol, key
    assert np.isfinite(res.eigenvectors).all()
    assert _rel(res.eigenvalues, jres.eigenvalues) < tol
