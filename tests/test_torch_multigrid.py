"""The port's main path against the JAX package, end to end (CPU, small).

JAX builds the hierarchy of a 642-vertex perturbed icosphere (levels
[64, 160] + the full cloud, k = 5) and saves it; the port loads the
files, so both packages train on identical inputs. The node features
agree except for the coarsest level's residual-magnitude column: that
level's U is eigsh's exact solution, so its residual is fp32 round-off
normalized to O(1), different in any two implementations. The training
comparison therefore feeds JAX's features to both (the rest of the
features are held to rel 1e-4 separately). With the flax initialization
carried over (`from_flax_params`) and the same polish guard vectors:

  * the loss histories agree to rel 1e-4 over the first 50 epochs
    (fp32 sums in another order, carried through 50 Adam steps);
  * the polished eigenvalues agree with the JAX package's to rel 1e-3
    and with eigsh to rel 1e-2 (test_multigrid_lobpcg_polish's bar).

The port's own `build_hierarchy` is held to the JAX build on the same
mesh, both on the numpy host path and both on the native one (the
icosphere's exact kNN distance ties are listed in another order by the
compiled kNN, so the two paths give different hierarchies), and
`Hierarchy.save` to the JAX on-disk layout.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from eigenpinns_tpu.configs import Config as JConfig
from eigenpinns_tpu.geometry import native as j_native
from eigenpinns_tpu.geometry.mesh import TriMesh as JTriMesh
from eigenpinns_tpu.models import make_corrector as j_make_corrector
from eigenpinns_tpu.sampling import build_hierarchy as j_build
from eigenpinns_tpu.sampling.hierarchy import Hierarchy as JHierarchy
from eigenpinns_tpu.solvers import multigrid as j_multigrid
from eigenpinns_tpu.solvers.multigrid import MultigridTrainer as JTrainer
from eigenpinns_tpu.sparse import neighbor_mean_operator as j_nm_op
from eigenpinns_tpu.train.loop import run_scan_loop as j_run_scan_loop
from eigenpinns_torch.configs import Config
from eigenpinns_torch.geometry import native as t_native
from eigenpinns_torch.models import from_flax_params, make_corrector
from eigenpinns_torch.sampling import Hierarchy, build_hierarchy
from eigenpinns_torch.solvers import MultigridTrainer, eigsh_smallest
from eigenpinns_torch.sparse import BSRTile, RollingBanded
from eigenpinns_torch.utils.fixtures import perturbed_icosphere

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)

LEVELS, K_MODES = [64, 160], 5
CFG = dict(n_modes=K_MODES, hierarchy=LEVELS, hidden_layers=[32, 32],
           epochs=50, scan_chunk=25, scale_ramp_epochs=100,
           corrector_scale=1.0, log_every=0, plateau_patience=10_000,
           polish_iters=150)


@pytest.fixture(scope="module")
def mesh():
    return perturbed_icosphere(3)


@pytest.fixture(scope="module")
def jax_hierarchy(mesh, tmp_path_factory):
    """Built on the JAX package's numpy host path (the port's build that
    is held to it takes its numpy path too): the icosphere has exact kNN
    distance ties that the compiled kNN lists in another order, which
    changes the local triangulations."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        h = j_build(JTriMesh(mesh.verts, mesh.faces), LEVELS,
                    n_modes=K_MODES, pc_neighbors=15,
                    operator_format="auto")
    d = str(tmp_path_factory.mktemp("jax_h"))
    h.save(d)
    return h, d


@pytest.fixture(scope="module")
def jax_run(jax_hierarchy):
    """The JAX trainer's result, its initial flax parameters, the polish
    guard vectors (both drawn exactly as the JAX trainer does) and the
    node features it trained on."""
    h, _ = jax_hierarchy
    cfg = JConfig(**CFG)
    n_total = sum(h.actual_hierarchy)
    edges = np.concatenate([np.asarray(e) + off for e, off in
                            zip(h.edge_index_list, h.node_offsets)], axis=1)
    model = j_make_corrector("simple", CFG["hidden_layers"], K_MODES)
    params = model.init(jax.random.PRNGKey(cfg.seed),
                        jnp.zeros((n_total, 9 + K_MODES)),
                        j_nm_op(edges, n_total))
    guard = np.asarray(jax.random.normal(
        jax.random.PRNGKey(cfg.seed + 7),
        (h.actual_hierarchy[-1], cfg.polish_guard), jnp.float32))
    seen = {}

    def recording_loop(*args, **kw):
        seen["feats"] = np.asarray(kw["data"]["feats"])
        return j_run_scan_loop(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_multigrid, "run_scan_loop", recording_loop)
        result = JTrainer(cfg).train(h)
    return result, params, guard, seen["feats"]


def test_load_reads_jax_layout_into_identical_operators(jax_hierarchy):
    jh, d = jax_hierarchy
    h = Hierarchy.load(d, operator_format="auto", device="cpu")
    assert h.actual_hierarchy == jh.actual_hierarchy
    for top, jop in zip(h.K_ops, jh.K_ops):
        assert isinstance(top, RollingBanded)
        assert (top.pre, top.win) == (jop.pre, jop.win)
        np.testing.assert_array_equal(top.band.numpy(), np.asarray(jop.band))
    tK, tM = h.fused_level_ops()
    jK, jM = jh.fused_level_ops()
    np.testing.assert_array_equal(tK.band.numpy(), np.asarray(jK.band))
    np.testing.assert_array_equal(tM.diag.numpy(), np.asarray(jM.diag))
    for U, jU in zip(h.U_list, jh.U_list):
        np.testing.assert_array_equal(U.numpy(), np.asarray(jU))


class _Stop(Exception):
    pass


def test_features_match_jax_but_coarsest_residual(jax_hierarchy, jax_run):
    feats_j = jax_run[3]
    h = Hierarchy.load(jax_hierarchy[1], operator_format="auto",
                       device="cpu")
    seen = {}
    build = MultigridTrainer._build_features

    def recording_build(self, *args):
        seen["feats"] = build(self, *args).numpy()
        raise _Stop   # before training

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(MultigridTrainer, "_build_features", recording_build)
        with pytest.raises(_Stop):
            MultigridTrainer(Config(**CFG)).train(h)
    feats, n0 = seen["feats"], h.actual_hierarchy[0]
    RES_MAG = 7   # [xyz, level, degree, diag K, diag M, |residual|, ...]
    for c in range(feats.shape[1]):
        rows = slice(n0, None) if c == RES_MAG else slice(None)
        ref = feats_j[rows, c]
        err = np.abs(feats[rows, c] - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1.0), c


def test_training_and_polish_match_jax(jax_hierarchy, jax_run, monkeypatch):
    jres, jparams, guard, feats_j = jax_run
    h = Hierarchy.load(jax_hierarchy[1], operator_format="auto",
                       device="cpu")
    model = from_flax_params(
        make_corrector("simple", feats_j.shape[1], CFG["hidden_layers"],
                       K_MODES),
        jax.tree_util.tree_map(np.asarray, jparams))
    monkeypatch.setattr(MultigridTrainer, "_build_features",
                        lambda self, *args: torch.from_numpy(feats_j.copy()))
    res = MultigridTrainer(Config(**CFG)).train(
        h, init_params=model.state_dict(), guard_block=guard)
    loss, jloss = res.history["loss"], np.asarray(jres.history["loss"])
    assert res.epochs_run == jres.epochs_run == 50
    assert np.abs(loss - jloss).max() / np.abs(jloss).max() < 1e-4
    for key in ("res", "orth", "scale"):
        np.testing.assert_allclose(res.history[key], jres.history[key],
                                   rtol=1e-4, atol=1e-6)
    lam, jlam = res.eigenvalues, np.asarray(jres.eigenvalues)
    np.testing.assert_allclose(lam[1:], jlam[1:], rtol=1e-3)
    vals, _ = eigsh_smallest(h.K_scipy[-1], h.M_scipy[-1], K_MODES)
    assert (np.abs(lam[1:] - vals[1:]) / vals[1:]).max() < 1e-2
    assert abs(lam[0]) < 1e-4
    assert res.eigenvectors.shape == (h.actual_hierarchy[-1], K_MODES)


def test_build_hierarchy_matches_jax_build(mesh, jax_hierarchy,
                                           monkeypatch):
    jh, _ = jax_hierarchy
    monkeypatch.setattr(t_native, "available", lambda: False)
    h = build_hierarchy(mesh, LEVELS, n_modes=K_MODES, pc_neighbors=15,
                        operator_format="auto", device="cpu")
    _assert_hierarchies_equal(h, jh)


def test_build_hierarchy_matches_jax_native_build(mesh):
    """Both packages on their compiled kNN, FPS, triangulation and flips
    (the same C++ source)."""
    if not (j_native.available() and t_native.available()):
        pytest.skip("a native geometry library did not build")
    jh = j_build(JTriMesh(mesh.verts, mesh.faces), LEVELS, n_modes=K_MODES,
                 pc_neighbors=15, operator_format="auto")
    h = build_hierarchy(mesh, LEVELS, n_modes=K_MODES, pc_neighbors=15,
                        operator_format="auto", device="cpu")
    _assert_hierarchies_equal(h, jh)
    for e, je in zip(h.edge_index_list, jh.edge_index_list):
        np.testing.assert_array_equal(e, np.asarray(je))


def _assert_hierarchies_equal(h, jh):
    assert h.actual_hierarchy == jh.actual_hierarchy
    for i in range(h.n_levels):
        np.testing.assert_array_equal(h.perms[i], jh.perms[i])
        assert abs(h.K_scipy[i] - jh.K_scipy[i]).max() < 1e-12
        np.testing.assert_allclose(h.X_list[i], jh.X_list[i])
        U, jU = h.U_list[i].numpy(), np.asarray(jh.U_list[i])
        # eigsh's sign convention is shared; rel 1e-5 covers fp32 Jacobi
        assert np.abs(U - jU).max() / np.abs(jU).max() < 1e-5
    np.testing.assert_allclose(h.coarse_eigenvalues, jh.coarse_eigenvalues,
                               atol=1e-10)


def test_save_writes_the_jax_layout(mesh, jax_hierarchy, tmp_path):
    jh, jdir = jax_hierarchy
    h = Hierarchy.load(jdir, operator_format="auto", device="cpu")
    h.save(str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == sorted(os.listdir(jdir))
    back = JHierarchy.load(str(tmp_path), operator_format="auto")
    ref = np.load(os.path.join(jdir, "hierarchy.npz"))
    ours = np.load(os.path.join(tmp_path, "hierarchy.npz"))
    assert sorted(ref.files) == sorted(ours.files)
    for key in ref.files:
        np.testing.assert_array_equal(ours[key], ref[key])
    for P, jP in zip(back.P_ops, jh.P_ops):
        assert abs(P.to_scipy() - jP.to_scipy()).max() == 0


@pytest.mark.parametrize("options", [
    {}, {"normalize_in_loss": True}, {"w_zero_mean": 0.5},
    {"weight_projection": 1.0}])
def test_fused_loss_equals_per_level_loss(jax_hierarchy, options):
    """The block-diagonal K_blk loss and the per-level loss (spmm_gram on
    each level's operators) are the same function: equal histories over
    5 epochs to rel 1e-5."""
    h = Hierarchy.load(jax_hierarchy[1], operator_format="auto",
                       device="cpu")
    cfg = dict(CFG, epochs=5, scan_chunk=5, polish_iters=0, **options)
    fused = MultigridTrainer(Config(**cfg)).train(h)
    per_level = MultigridTrainer(Config(**cfg, fuse_level_ops=False)).train(h)
    for key in ("loss", "res", "orth", "proj"):
        np.testing.assert_allclose(fused.history[key],
                                   per_level.history[key], rtol=1e-5,
                                   atol=1e-7)
    if "weight_projection" in options:
        assert fused.history["proj"][0] > 0


@pytest.mark.parametrize("option", ["mesh_shape", "timing_chunks"])
def test_unported_options_raise(jax_hierarchy, option):
    h = Hierarchy.load(jax_hierarchy[1], operator_format="auto",
                       device="cpu")
    kw = {option: {"mesh_shape": [2], "timing_chunks": 2}[option]}
    with pytest.raises(NotImplementedError, match=option):
        MultigridTrainer(Config(**CFG, **kw)).train(h)


_BSR_FIELDS = ("data", "cid", "rowid", "nw", "diag", "gcid", "lcid", "gid")


def _assert_bsr_equal(top, jop):
    assert isinstance(top, BSRTile)
    assert (top.n, top.n_cols, top.tile) == (jop.n, jop.n_cols, jop.tile)
    for name in _BSR_FIELDS:
        np.testing.assert_array_equal(getattr(top, name).numpy(),
                                      np.asarray(getattr(jop, name)), name)


def test_wide_k_raises_for_unported_bsr(mesh):
    """k > 32 (the name dates from when this raised): every level's K,
    and the fused K_blk, is a strip-BSR operator whose layout equals the
    JAX build's, and the Jacobi-smoothed guesses agree to rel 1e-5. Both
    packages on the numpy host path."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        mp.setattr(t_native, "available", lambda: False)
        _assert_wide_k_builds_equal(mesh)


def test_wide_k_bsr_levels_match_jax_native_build(mesh):
    """The same on both packages' native host path."""
    if not (j_native.available() and t_native.available()):
        pytest.skip("a native geometry library did not build")
    _assert_wide_k_builds_equal(mesh)


def _assert_wide_k_builds_equal(mesh):
    jh = j_build(JTriMesh(mesh.verts, mesh.faces), [64], n_modes=40,
                 pc_neighbors=15, operator_format="auto")
    h = build_hierarchy(mesh, [64], n_modes=40, pc_neighbors=15,
                        operator_format="auto", device="cpu")
    assert h.actual_hierarchy == jh.actual_hierarchy
    for i in range(h.n_levels):
        np.testing.assert_array_equal(h.perms[i], jh.perms[i])
        _assert_bsr_equal(h.K_ops[i], jh.K_ops[i])
        U, jU = h.U_list[i].numpy(), np.asarray(jh.U_list[i])
        assert np.abs(U - jU).max() / np.abs(jU).max() < 1e-5
    _assert_bsr_equal(h.fused_level_ops()[0], jh.fused_level_ops()[0])
