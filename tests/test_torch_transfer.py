"""Parity of the port's upscaler, transfer, checkpoint, surgery, fixture
and Dirichlet modules with JAX (CPU, small).

Tolerances:

  * `hierarchical_eigensolve` on the 1D Laplacian at n = 128, levels
    [48] (the JAX test's problem), flax upscaler parameters carried in:
    eigenvalues rel 1e-4 (relative to the largest);
  * `train_per_level` on a 642-vertex perturbed icosphere: JAX builds the
    hierarchy on its numpy host path and saves it, the port loads the
    files (as in test_torch_multigrid.py), both train from the same flax
    corrector with a freeze schedule; the loss, residual, orthogonality
    and projection histories of every level rel 1e-4, the level and
    final eigenvalues rel 1e-4; the frozen layer is bit-identical across
    its level and each `level_<l>` checkpoint restores the saved tensors;
  * the same at k = 10 over three levels, with both packages' anchoring
    Ritz vectors fixed by `align_ritz_vectors` (as run, the level-2
    losses part by ~0.1: each eigh picks its own signs and rotations of
    near-degenerate pairs); every history rel 1e-4;
  * `partial_weight_copy`: copy in flax then convert equals convert then
    copy in torch, exactly;
  * checkpoints: a round trip restores exactly, with the target's kinds
    and dtypes, and an overwrite is atomic (a failed save leaves the old
    file and no temporary file);
  * `subsample_hierarchy`: equal indices for all four methods;
  * Dirichlet solves on a perturbed_icosphere(3) Laplacian (the JAX
    test's square mesh needs the unported FEM assembly): the host solves
    equal to 1e-10; the device CG equal to the JAX CG at the same
    cg_iters to 1e-5, on the ELL operator and on strip-BSR (the strip-BSR
    kernel's plain version here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from eigenpinns_tpu.geometry import native as j_native
from eigenpinns_tpu.geometry.mesh import TriMesh as JTriMesh
from eigenpinns_tpu.models import HierarchicalUpscaler as JUpscaler
from eigenpinns_tpu.models import MLP as JMLP
from eigenpinns_tpu.models import SimpleCorrector as JSimpleCorrector
from eigenpinns_tpu.models import partial_weight_copy as j_partial_copy
from eigenpinns_tpu.sampling import build_hierarchy as j_build
from eigenpinns_tpu.solvers import hierarchical_eigensolve as j_hier
from eigenpinns_tpu.solvers import solve_laplace_dirichlet as j_dirichlet
from eigenpinns_tpu.solvers import (
    solve_laplace_dirichlet_device as j_dirichlet_device,
)
from eigenpinns_tpu.solvers import train_per_level as j_per_level
from eigenpinns_tpu.solvers import transfer as j_transfer
from eigenpinns_tpu.sparse import as_operator as j_as_operator
from eigenpinns_tpu.sparse import neighbor_mean_operator as j_nm_op
from eigenpinns_tpu.utils import fixtures as j_fixtures
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.models import (
    MLP,
    HierarchicalUpscaler,
    SimpleCorrector,
    from_flax_params,
    partial_weight_copy,
)
from eigenpinns_torch.sampling import Hierarchy
from eigenpinns_torch.solvers import (
    hierarchical_eigensolve,
    solve_laplace_dirichlet,
    solve_laplace_dirichlet_device,
    train_per_level,
)
from eigenpinns_torch.sparse import BSRTile, as_operator
from eigenpinns_torch.train import (
    TrainCheckpointer,
    freeze_mask,
    restore_checkpoint,
    save_checkpoint,
)
from eigenpinns_torch.solvers import transfer as t_transfer
from eigenpinns_torch.train import checkpoint as t_checkpoint
from eigenpinns_torch.utils import fixtures as t_fixtures
from eigenpinns_torch.utils.fixtures import (
    align_ritz_vectors,
    perturbed_icosphere,
)

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ---- hierarchical_eigensolve ---------------------------------------------

def test_hierarchical_eigensolve_matches_jax():
    n, k, hidden, seed = 128, 3, (32, 32), 0
    K, M = t_fixtures.generate_test_matrices(n, "laplacian")
    kw = dict(levels=[48], hidden=hidden, epochs_per_level=300, lr=3e-3,
              seed=seed)
    jr = j_hier(K, M, k, **kw)
    # The JAX driver initializes pair p of level l from
    # PRNGKey(seed + 101 l + p); the shapes are all flax's init needs.
    init = []
    for pair in range(k):
        tree = JUpscaler(hidden, n).init(
            jax.random.PRNGKey(seed + 101 + pair), jnp.zeros(48),
            jnp.zeros(n))
        net = HierarchicalUpscaler(48, hidden, n)
        init.append(from_flax_params(net, _np(tree)).state_dict())
    tr = hierarchical_eigensolve(K, M, k, device="cpu", init_params=init,
                                 **kw)
    assert tr.level_sizes == jr.level_sizes == [48, 128]
    assert _rel(tr.eigenvalues, jr.eigenvalues) < 1e-4
    assert np.isfinite(tr.eigenvectors).all()


# ROADMAP F27. On the JAX test's quick harness
# (tests/test_upscale_transfer.py::test_hierarchical_eigensolve_quick:
# n = 128, levels [48], 3 pairs, hidden (64, 64), 1200 epochs, lr 3e-3,
# bar 0.15), the JAX package's own initialization clears the bar on 6 of
# seeds 0..9 on the CPU (upscale_seeds_jax_reference.py: 0.1019, 0.0886,
# 0.7528, 0.1531, 0.0542, 0.0519, 0.2545, 0.1619, 0.1331, 0.0576).
UPSCALE_QUICK_JAX_CLEARS = 6


@pytest.mark.slow
def test_hierarchical_eigensolve_clears_the_bar_as_often_as_jax():
    """The port's own initialization clears the JAX test's bar on at
    least as many of seeds 0..9 as the JAX package's does."""
    n, k = 128, 3
    K, M = t_fixtures.generate_test_matrices(n, "laplacian")
    exact = t_fixtures.laplacian_1d_eigenvalues(n, k)
    errs = []
    for seed in range(10):
        res = hierarchical_eigensolve(K, M, k, levels=[48], hidden=(64, 64),
                                      epochs_per_level=1200, lr=3e-3,
                                      seed=seed, device="cpu")
        errs.append(float((np.abs(np.sort(res.eigenvalues) - exact)
                           / exact).max()))
    assert sum(e < 0.15 for e in errs) >= UPSCALE_QUICK_JAX_CLEARS, errs


# ---- train_per_level -------------------------------------------------------

# k = 3: at k = 5 the level-1 Ritz pair 1.6917 / 1.7020 (0.6% apart)
# comes out of the two packages' fp32 eigh rotated by ~1e-4, and the
# projection loss of level 2 anchors to those rotated columns.
LEVELS, K_MODES, HIDDEN = [64, 160], 3, (32, 32)
FREEZE = {2: 1}


@pytest.fixture(scope="module")
def hierarchy_dir(tmp_path_factory):
    """JAX's hierarchy of a 642-vertex perturbed icosphere on its numpy
    host path, saved for the port to load."""
    mesh = perturbed_icosphere(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        h = j_build(JTriMesh(mesh.verts, mesh.faces), LEVELS,
                    n_modes=K_MODES, pc_neighbors=15,
                    operator_format="auto")
    d = str(tmp_path_factory.mktemp("jax_h"))
    h.save(d)
    return h, d


def test_train_per_level_matches_jax(hierarchy_dir, tmp_path):
    jh, d = hierarchy_dir
    kw = dict(n_modes=K_MODES, hidden=HIDDEN, epochs_per_level=40,
              scan_chunk=20, freeze_schedule=FREEZE, seed=0)
    jr = j_per_level(jh, **kw)
    n1 = jh.actual_hierarchy[1]
    tree = JSimpleCorrector(HIDDEN, K_MODES).init(
        jax.random.PRNGKey(0), jnp.zeros((n1, 9 + K_MODES)),
        j_nm_op(jh.edge_index_list[1], n1))
    model = from_flax_params(SimpleCorrector(9 + K_MODES, HIDDEN, K_MODES),
                             _np(tree))
    h = Hierarchy.load(d, operator_format="auto", device="cpu")
    ckdir = str(tmp_path / "ck")
    tr = train_per_level(h, init_params=model.state_dict(),
                         checkpoint_dir=ckdir, **kw)
    assert len(tr.histories) == len(jr.histories) == 2
    for level, (th, jhist) in enumerate(zip(tr.histories, jr.histories)):
        for key in ("loss", "res", "orth", "proj"):
            assert _rel(th[key], jhist[key]) < 1e-4, (level, key)
    for lam, jlam in zip(tr.level_eigenvalues, jr.level_eigenvalues):
        assert _rel(lam, jlam) < 1e-4
    assert _rel(tr.eigenvalues, jr.eigenvalues) < 1e-4
    assert tr.eigenvectors.shape == (h.actual_hierarchy[-1], K_MODES)

    # Level 2 froze hidden layer 0: its tensors did not move; the rest
    # trained.
    before, after = tr.level_params
    labels = freeze_mask(model.named_parameters(), 1)
    assert {n for n, lab in labels.items() if lab == "frozen"} == {
        "mlp.hidden.0.weight", "mlp.hidden.0.bias"}
    for name, label in labels.items():
        same = torch.equal(before[name], after[name])
        assert same == (label == "frozen"), name
    for level, params in ((1, before), (2, after)):
        path = os.path.join(ckdir, f"level_{level}")
        target = {"params": params,
                  "lambda_refined": tr.level_eigenvalues[level]}
        restored = restore_checkpoint(path, target=target)
        for name, t in params.items():
            assert torch.equal(restored["params"][name], t)
        np.testing.assert_array_equal(restored["lambda_refined"],
                                      tr.level_eigenvalues[level])


def test_train_per_level_with_fixed_ritz_vectors_matches_jax(tmp_path,
                                                            monkeypatch):
    """k = 10 (the smoke's), three levels and the smoke's freeze schedule.
    The Ritz vectors that anchor each level to the one below are fixed up
    to the signs and near-degenerate rotations each package's eigh picks,
    so that every level can be compared."""
    k, levels, hidden = 10, [64, 160, 320], (32, 32)
    mesh = perturbed_icosphere(3)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        jh = j_build(JTriMesh(mesh.verts, mesh.faces), levels, n_modes=k,
                     pc_neighbors=15, operator_format="auto")
    jh.save(str(tmp_path))
    h = Hierarchy.load(str(tmp_path), operator_format="auto", device="cpu")
    j_rr, t_rr = j_transfer.rayleigh_ritz, t_transfer.rayleigh_ritz

    def j_fixed(U, K, M, jitter=0.0):
        w, V = j_rr(U, K, M, jitter)
        return w, jnp.asarray(align_ritz_vectors(np.asarray(w),
                                                 np.asarray(V)))

    def t_fixed(U, K, M, jitter=0.0):
        w, V = t_rr(U, K, M, jitter)
        return w, torch.as_tensor(align_ritz_vectors(w.numpy(), V.numpy()))

    monkeypatch.setattr(j_transfer, "rayleigh_ritz", j_fixed)
    monkeypatch.setattr(t_transfer, "rayleigh_ritz", t_fixed)
    kw = dict(n_modes=k, hidden=hidden, epochs_per_level=40, scan_chunk=20,
              freeze_schedule={2: 1, 3: 2}, seed=0)
    jr = j_per_level(jh, **kw)
    n1 = jh.actual_hierarchy[1]
    tree = JSimpleCorrector(hidden, k).init(
        jax.random.PRNGKey(0), jnp.zeros((n1, 9 + k)),
        j_nm_op(jh.edge_index_list[1], n1))
    model = from_flax_params(SimpleCorrector(9 + k, hidden, k), _np(tree))
    tr = train_per_level(h, init_params=model.state_dict(), **kw)
    assert len(tr.histories) == len(jr.histories) == 3
    for level, (th, jhist) in enumerate(zip(tr.histories, jr.histories)):
        for key in ("loss", "res", "orth", "proj"):
            assert _rel(th[key], jhist[key]) < 1e-4, (level, key)
    for lam, jlam in zip(tr.level_eigenvalues, jr.level_eigenvalues):
        assert _rel(lam, jlam) < 1e-4
    assert _rel(tr.eigenvalues, jr.eigenvalues) < 1e-4


# ---- surgery, checkpoints, fixtures ---------------------------------------

def test_partial_weight_copy_matches_flax():
    """An MLP re-created with a wider input and a narrower output: flax
    surgery then conversion equals conversion then torch surgery."""
    j_old, j_new = JMLP((16, 16), 6), JMLP((16, 16), 4)
    old = j_old.init(jax.random.PRNGKey(0), jnp.zeros((2, 5)))
    new = j_new.init(jax.random.PRNGKey(1), jnp.zeros((2, 8)))
    via_flax = from_flax_params(MLP(8, (16, 16), 4),
                                _np(j_partial_copy(old, new))).state_dict()
    t_old = from_flax_params(MLP(5, (16, 16), 6), _np(old)).state_dict()
    t_new = from_flax_params(MLP(8, (16, 16), 4), _np(new)).state_dict()
    via_torch = partial_weight_copy(t_old, t_new)
    assert set(via_torch) == set(via_flax)
    for name in via_flax:
        assert torch.equal(via_torch[name], via_flax[name]), name
    assert not torch.equal(t_new["hidden.0.weight"],
                           via_torch["hidden.0.weight"])


def test_checkpoint_roundtrip_and_atomic_overwrite(tmp_path, monkeypatch):
    tree = {"params": {"w": torch.arange(6.0).reshape(2, 3)},
            "lam": np.asarray([1.0, 2.0]), "step": 7,
            "blocks": [np.float32(0.5), torch.ones(2, dtype=torch.int32)]}
    path = save_checkpoint(str(tmp_path / "ckpt"), tree)
    restored = restore_checkpoint(path, target=tree)
    assert torch.equal(restored["params"]["w"], tree["params"]["w"])
    assert restored["lam"].dtype == np.float64
    np.testing.assert_array_equal(restored["lam"], tree["lam"])
    assert restored["step"] == 7
    assert restored["blocks"][0] == np.float32(0.5)
    assert torch.equal(restored["blocks"][1], tree["blocks"][1])
    with pytest.raises(ValueError):
        restore_checkpoint(path, target={**tree, "lam": np.zeros(3)})

    # Overwrite: a save that fails midway leaves the old checkpoint and
    # no temporary file; a save that succeeds replaces it.
    def broken_save(obj, f):
        f.write(b"torn")
        raise OSError("disk full")

    monkeypatch.setattr(t_checkpoint.torch, "save", broken_save)
    with pytest.raises(OSError):
        save_checkpoint(path, {"params": {"w": torch.zeros(2, 3)}})
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["ckpt"]
    assert torch.equal(restore_checkpoint(path)["params"]["w"],
                       tree["params"]["w"])
    save_checkpoint(path, {"params": {"w": torch.zeros(2, 3)}})
    assert torch.equal(restore_checkpoint(path)["params"]["w"],
                       torch.zeros(2, 3))
    assert os.listdir(tmp_path) == ["ckpt"]

    ckptr = TrainCheckpointer(str(tmp_path / "run"))
    assert ckptr.restore_latest() == (None, None)
    ckptr.save(10, tree)
    ckptr.save(20, {**tree, "step": 20})
    step, latest = ckptr.restore_latest(target=tree)
    assert step == 20 and latest["step"] == 20


@pytest.mark.parametrize("method", ["uniform", "random", "leverage",
                                    "maxdist"])
def test_subsample_hierarchy_matches_jax(method):
    K, _ = t_fixtures.generate_test_matrices(200, "tridiagonal", seed=4)
    t_levels = t_fixtures.subsample_hierarchy(200, [20, 60], method=method,
                                              K=K, seed=3)
    j_levels = j_fixtures.subsample_hierarchy(200, [20, 60], method=method,
                                              K=K, seed=3)
    assert len(t_levels) == len(j_levels) == 3
    for a, b in zip(t_levels, j_levels):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["laplacian", "tridiagonal", "random_spd"])
def test_matrix_fixtures_match_jax(kind):
    tK, tM = t_fixtures.generate_test_matrices(60, kind, seed=2)
    jK, jM = j_fixtures.generate_test_matrices(60, kind, seed=2)
    assert (tK != jK).nnz == 0 and (tM != jM).nnz == 0
    vals, vecs = scipy.linalg.eigh(tK.toarray(), tM.toarray())
    t_rel, t_defect, t_ok = t_fixtures.verify_eigenpairs(tK, tM, vals, vecs)
    j_rel, j_defect, j_ok = j_fixtures.verify_eigenpairs(jK, jM, vals, vecs)
    np.testing.assert_array_equal(t_rel, j_rel)
    assert (t_defect, t_ok) == (j_defect, j_ok)
    assert t_ok
    np.testing.assert_array_equal(
        t_fixtures.laplacian_1d_eigenvalues(60, 5),
        j_fixtures.laplacian_1d_eigenvalues(60, 5))


# ---- Dirichlet solves ------------------------------------------------------

@pytest.fixture(scope="module")
def dirichlet_problem():
    mesh = perturbed_icosphere(3)
    L, _ = point_cloud_laplacian(mesh.verts, n_neighbors=15)
    z = mesh.verts[:, 2]
    mask = (z > 0.8) | (z < -0.8)
    vals = np.where(z > 0.8, 1.0, 0.0)
    return L, mask, vals


def test_dirichlet_host_matches_jax(dirichlet_problem):
    L, mask, vals = dirichlet_problem
    idx = np.where(mask)[0]
    u = solve_laplace_dirichlet(L, idx, vals[idx])
    uj = j_dirichlet(L, idx, vals[idx])
    assert np.abs(u - uj).max() <= 1e-10
    assert np.abs(u[idx] - vals[idx]).max() == 0.0


@pytest.mark.parametrize("fmt", ["ell", "bsr"])
def test_dirichlet_device_cg_matches_jax(dirichlet_problem, fmt):
    L, mask, vals = dirichlet_problem
    cg_iters = 150
    uj = np.asarray(j_dirichlet_device(
        j_as_operator(L), jnp.asarray(mask),
        jnp.asarray(vals, jnp.float32), cg_iters=cg_iters))
    if fmt == "ell":
        op, perm = as_operator(L, device="cpu"), np.arange(L.shape[0])
    else:
        op, perm = BSRTile.from_scipy(L, device="cpu")
    u = solve_laplace_dirichlet_device(
        op, torch.as_tensor(mask[perm]),
        torch.as_tensor(vals[perm], dtype=torch.float32),
        cg_iters=cg_iters).numpy()
    assert np.abs(u - uj[perm]).max() <= 1e-5
    idx = np.where(mask)[0]
    host = solve_laplace_dirichlet(L, idx, vals[idx])
    assert np.abs(u - host[perm]).max() <= 1e-3
