"""The port's pipeline core against the JAX package (CPU, small).

On perturbed_icosphere(2) (162 vertices, levels [24, 64] + the full
mesh) for the builds and on perturbed_icosphere(3) (642 vertices,
levels [64, 160]) for the training:

  * `build_hierarchy` for every sampler type x edge type, in the 'auto'
    and 'ell' formats, equals the JAX build: permutations, operator
    layouts, edges and the host K/M exactly, the initial guesses to rel
    1e-5. Both packages take the numpy triangulation (the icosphere's
    exact kNN ties are listed in another order by the compiled kNN) and
    the decimated meshes of one `decimation_levels` call, which
    tests/test_torch_mesh.py holds identical between the packages;
  * `coarse_solver='lobpcg'` gives the JAX package's and eigsh's coarse
    eigenvalues to rel 1e-4 (the random starts differ);
  * the graph_coarsening hierarchy trains with a rolling-band K *and*
    consistent M: with the flax initialization carried in and JAX's node
    features fed to both (the coarsest level's residual column is fp32
    round-off normalized to O(1)), the losses agree epoch by epoch to rel
    1e-4 over 30 epochs and the `eval_callback` predictions to rel 1e-4.
    The port's polished eigenvalues agree with eigsh to rel 1e-5; the
    JAX package's fp32 polish on this consistent mass stops 2e-5..6e-5
    from eigsh (150 or 300 iterations alike), so the two packages are
    held to each other at rel 1e-4;
  * a run resumed from `checkpoint_dir` repeats an uninterrupted run, and
    `profile_dir` writes a Chrome trace.
"""

import json
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
from eigenpinns_tpu.sampling import hierarchy as j_hierarchy_mod
from eigenpinns_tpu.solvers import multigrid as j_multigrid
from eigenpinns_tpu.solvers.multigrid import MultigridTrainer as JTrainer
from eigenpinns_tpu.sparse import neighbor_mean_operator as j_nm_op
from eigenpinns_tpu.train.loop import run_scan_loop as j_run_scan_loop
from eigenpinns_torch.configs import Config
from eigenpinns_torch.geometry import TriMesh
from eigenpinns_torch.geometry import native as t_native
from eigenpinns_torch.models import from_flax_params, make_corrector
from eigenpinns_torch.sampling import (
    COARSE_SOLVERS,
    EDGE_TYPES,
    SAMPLER_TYPES,
    build_hierarchy,
    decimation_levels,
)
from eigenpinns_torch.sampling import hierarchy as t_hierarchy_mod
from eigenpinns_torch.solvers import MultigridTrainer, eigsh_smallest
from eigenpinns_torch.sparse import RollingBanded
from eigenpinns_torch.utils.fixtures import perturbed_icosphere

torch.set_num_threads(2)

LEVELS, K_MODES = [64, 160], 5
SMALL_LEVELS = [24, 64]
CFG = dict(n_modes=K_MODES, hierarchy=LEVELS, hidden_layers=[32, 32],
           epochs=30, scan_chunk=10, scale_ramp_epochs=100,
           corrector_scale=1.0, log_every=0, plateau_patience=10_000,
           polish_iters=150)
BUILD = dict(n_modes=K_MODES, pc_neighbors=15)


@pytest.fixture(scope="module")
def mesh():
    return perturbed_icosphere(2)


def _one_decimation(mp, mesh, levels):
    """Both packages' `build_hierarchy` on one decimation."""
    meshes = [(m.verts, m.faces) for m in decimation_levels(mesh, levels)]
    mp.setattr(j_hierarchy_mod, "decimation_levels",
               lambda m, h: [JTriMesh(v, f) for v, f in meshes])
    mp.setattr(t_hierarchy_mod, "decimation_levels",
               lambda m, h: [TriMesh(v, f) for v, f in meshes])


@pytest.fixture(scope="module")
def same_host_path(mesh):
    """Both packages on the numpy triangulation and on one decimation."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_native, "available", lambda: False)
        mp.setattr(t_native, "available", lambda: False)
        _one_decimation(mp, mesh, SMALL_LEVELS)
        yield


def _builds(mesh, levels=SMALL_LEVELS, **kw):
    h = build_hierarchy(mesh, levels, device="cpu", **BUILD, **kw)
    jh = j_build(JTriMesh(mesh.verts, mesh.faces), levels, **BUILD, **kw)
    return h, jh


_FIELDS = ("band", "pre", "win", "n", "tile", "indices", "values", "n_cols",
           "diag", "data", "cid", "rowid", "nw", "gcid", "lcid", "gid")


def _assert_op_equal(top, jop):
    assert type(top).__name__ == type(jop).__name__
    for name in _FIELDS:
        if hasattr(top, name) and getattr(jop, name, None) is not None:
            a, b = getattr(top, name), getattr(jop, name)
            if isinstance(a, torch.Tensor):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b), name)
            else:
                assert a == b, name


def _assert_hierarchies_equal(h, jh, u_rtol=1e-5):
    assert h.actual_hierarchy == jh.actual_hierarchy
    assert (h.perms is None) == (jh.perms is None)
    for i in range(h.n_levels):
        if h.perms is not None:
            np.testing.assert_array_equal(h.perms[i], jh.perms[i])
        assert abs(h.K_scipy[i] - jh.K_scipy[i]).max() < 1e-12
        assert abs(h.M_scipy[i] - jh.M_scipy[i]).max() < 1e-12
        np.testing.assert_array_equal(h.X_list[i], jh.X_list[i])
        np.testing.assert_array_equal(h.edge_index_list[i],
                                      np.asarray(jh.edge_index_list[i]))
        _assert_op_equal(h.K_ops[i], jh.K_ops[i])
        _assert_op_equal(h.M_ops[i], jh.M_ops[i])
        U, jU = h.U_list[i].numpy(), np.asarray(jh.U_list[i])
        assert np.abs(U - jU).max() / np.abs(jU).max() < u_rtol
    for a, b in zip(h.indices_per_level, jh.indices_per_level):
        np.testing.assert_array_equal(a, b)
    for P, jP in zip(h.P_ops, jh.P_ops):
        _assert_op_equal(P, jP)
    assert [m.n_verts for m in h.meshes] == [m.n_verts for m in jh.meshes]


@pytest.mark.parametrize("fmt", ["auto", "ell"])
@pytest.mark.parametrize("edges", EDGE_TYPES + ("bogus",))
@pytest.mark.parametrize("sampler", SAMPLER_TYPES)
def test_build_hierarchy_matches_jax(mesh, same_host_path, sampler, edges,
                                     fmt):
    h, jh = _builds(mesh, sampler_type=sampler, edge_computation_type=edges,
                    operator_format=fmt)
    _assert_hierarchies_equal(h, jh)
    coarsening = sampler == "graph_coarsening"
    # FEM levels carry a consistent mass in K's format; point-cloud
    # levels a lumped (diagonal) one.
    assert all(type(M).__name__ == ("Diagonal" if not coarsening else
                                    type(K).__name__)
               for K, M in zip(h.K_ops, h.M_ops))
    if coarsening and edges == "connectivity_based":
        # Mesh edges, renumbered into each level's (permuted) order.
        for i, m in enumerate(h.meshes):
            e = m.edges(directed=True)
            if h.perms is not None:
                inv = np.argsort(h.perms[i])
                e = inv[e]
            np.testing.assert_array_equal(h.edge_index_list[i], e)
            assert h.edge_index_list[i].shape[1] == e.shape[1]


def test_hierarchy_rejects_unknown_options(mesh):
    for kw in ({"sampler_type": "bogus"}, {"coarse_solver": "arpack"},
               {"operator_format": "csr"}):
        with pytest.raises(ValueError):
            build_hierarchy(mesh, SMALL_LEVELS, n_modes=3, device="cpu",
                            **kw)
    assert COARSE_SOLVERS == j_hierarchy_mod.COARSE_SOLVERS
    assert SAMPLER_TYPES == j_hierarchy_mod.SAMPLER_TYPES
    assert EDGE_TYPES == j_hierarchy_mod.EDGE_TYPES


@pytest.mark.parametrize("sampler", ["graph_coarsening", "farthest_point"])
def test_lobpcg_coarse_solve(mesh, same_host_path, sampler):
    h, jh = _builds(mesh, sampler_type=sampler, operator_format="auto",
                    coarse_solver="lobpcg")
    vals, _ = eigsh_smallest(h.K_scipy[0], h.M_scipy[0], K_MODES)
    lam, jlam = h.coarse_eigenvalues, np.asarray(jh.coarse_eigenvalues)
    np.testing.assert_allclose(lam[1:], jlam[1:], rtol=1e-4)
    np.testing.assert_allclose(lam[1:], vals[1:], rtol=1e-4)
    assert abs(lam[0]) < 1e-5
    U0 = h.U_list[0].double().numpy()
    R = h.K_scipy[0] @ U0 - (h.M_scipy[0] @ U0) * lam
    assert np.linalg.norm(R, axis=0).max() < 1e-3


def test_to_original_order(mesh, same_host_path):
    h, jh = _builds(mesh, sampler_type="graph_coarsening",
                    operator_format="auto")
    U = np.random.default_rng(0).standard_normal((mesh.n_verts, 3))
    back = h.to_original_order(U)
    np.testing.assert_array_equal(back, jh.to_original_order(U))
    np.testing.assert_array_equal(back[h.perms[-1]], U)
    # The finest level's X is the mesh's vertices in the level's order.
    np.testing.assert_array_equal(h.to_original_order(h.X_list[-1]),
                                  mesh.verts)
    h_ell = build_hierarchy(mesh, SMALL_LEVELS,
                            sampler_type="graph_coarsening",
                            operator_format="ell", device="cpu", **BUILD)
    assert h_ell.perms is None and h_ell.to_original_order(U) is U


# ---- training on the graph_coarsening hierarchy ------------------------

@pytest.fixture(scope="module")
def coarsening_builds():
    mesh = perturbed_icosphere(3)
    with pytest.MonkeyPatch.context() as mp:
        _one_decimation(mp, mesh, LEVELS)
        return _builds(mesh, LEVELS, sampler_type="graph_coarsening",
                       edge_computation_type="connectivity_based",
                       operator_format="auto")


@pytest.fixture(scope="module")
def jax_run(coarsening_builds):
    """The JAX trainer's result, its initial flax parameters, the polish
    guard vectors, its node features and its eval_callback values."""
    _, jh = coarsening_builds
    cfg = JConfig(**CFG)
    n_total = sum(jh.actual_hierarchy)
    edges = np.concatenate([np.asarray(e) + off for e, off in
                            zip(jh.edge_index_list, jh.node_offsets)], axis=1)
    model = j_make_corrector("simple", CFG["hidden_layers"], K_MODES)
    params = model.init(jax.random.PRNGKey(cfg.seed),
                        jnp.zeros((n_total, 9 + K_MODES)),
                        j_nm_op(edges, n_total))
    guard = np.asarray(jax.random.normal(
        jax.random.PRNGKey(cfg.seed + 7),
        (jh.actual_hierarchy[-1], cfg.polish_guard), jnp.float32))
    seen, evals = {}, []

    def recording_loop(*args, **kw):
        seen["feats"] = np.asarray(kw["data"]["feats"])
        return j_run_scan_loop(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_multigrid, "run_scan_loop", recording_loop)
        result = JTrainer(cfg).train(
            jh, eval_callback=lambda e, U: evals.append((e, np.asarray(U))))
    return result, params, guard, seen["feats"], evals


def _port_train(h, jax_run, monkeypatch, eval_callback=None, **cfg):
    _, jparams, guard, feats_j, _ = jax_run
    model = from_flax_params(
        make_corrector("simple", feats_j.shape[1], CFG["hidden_layers"],
                       K_MODES),
        jax.tree_util.tree_map(np.asarray, jparams))
    monkeypatch.setattr(MultigridTrainer, "_build_features",
                        lambda self, *args: torch.from_numpy(feats_j.copy()))
    return MultigridTrainer(Config(**dict(CFG, **cfg))).train(
        h, init_params=model.state_dict(), guard_block=guard,
        eval_callback=eval_callback)


class _Stop(Exception):
    pass


def test_features_on_rolling_k_and_m_match_jax(coarsening_builds, jax_run):
    """The port's own node features on the mesh path (connectivity-edge
    degree, the diagonals of FEM K and consistent M, the residual and
    Rayleigh columns through K1's plain version) against the JAX
    trainer's, column by column; the coarsest level's residual is
    rounding noise of an exact solve in both and is left out."""
    h, _ = coarsening_builds
    feats_j = jax_run[3]
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
    assert feats.shape == feats_j.shape
    RES_MAG = 7   # [xyz, level, degree, diag K, diag M, |residual|, ...]
    for c in range(feats.shape[1]):
        rows = slice(n0, None) if c == RES_MAG else slice(None)
        ref = feats_j[rows, c]
        err = np.abs(feats[rows, c] - ref).max()
        assert err <= 1e-4 * max(np.abs(ref).max(), 1.0), c


def test_training_on_rolling_k_and_m_matches_jax(coarsening_builds, jax_run,
                                                 monkeypatch):
    h, _ = coarsening_builds
    assert all(isinstance(op, RollingBanded) for op in h.K_ops + h.M_ops)
    K_blk, M_blk = h.fused_level_ops()
    assert isinstance(K_blk, RollingBanded) and isinstance(M_blk,
                                                           RollingBanded)
    jres = jax_run[0]
    evals = []
    res = _port_train(h, jax_run, monkeypatch,
                      eval_callback=lambda e, U: evals.append((e, U)))
    loss, jloss = res.history["loss"], np.asarray(jres.history["loss"])
    assert res.epochs_run == jres.epochs_run == CFG["epochs"]
    assert (np.abs(loss - jloss) / np.abs(jloss)).max() < 1e-4
    for key in ("res", "orth", "scale"):
        np.testing.assert_allclose(res.history[key], jres.history[key],
                                   rtol=1e-4, atol=1e-7)
    vals, _ = eigsh_smallest(h.K_scipy[-1], h.M_scipy[-1], K_MODES)
    np.testing.assert_allclose(res.eigenvalues[1:], vals[1:], rtol=1e-5)
    np.testing.assert_allclose(res.eigenvalues[1:],
                               np.asarray(jres.eigenvalues)[1:], rtol=1e-4)
    # eval_callback: after every chunk, the M-normalized finest-level
    # prediction, as the JAX trainer hands it over.
    jevals = jax_run[4]
    assert [e for e, _ in evals] == [e for e, _ in jevals] == [10, 20, 30]
    for (_, U), (_, jU) in zip(evals, jevals):
        assert isinstance(U, torch.Tensor)
        assert U.shape == (h.actual_hierarchy[-1], K_MODES)
        assert np.abs(U.numpy() - jU).max() / np.abs(jU).max() < 1e-4


def test_checkpoint_resume_equals_uninterrupted_run(coarsening_builds,
                                                    jax_run, monkeypatch,
                                                    tmp_path):
    """20 epochs in one run, and 10 + 10 resumed from `checkpoint_dir`:
    the same losses (the epoch counter, and with it the corrector-scale
    ramp, continues) and the same eigenvalues."""
    h, _ = coarsening_builds
    short = dict(epochs=20, scan_chunk=5, polish_iters=20)
    whole = _port_train(h, jax_run, monkeypatch, **short)
    ckpt = str(tmp_path / "ckpt")
    first = _port_train(h, jax_run, monkeypatch, checkpoint_dir=ckpt,
                        **dict(short, epochs=10))
    assert sorted(os.listdir(ckpt)) == ["step_10"]
    second = _port_train(h, jax_run, monkeypatch, checkpoint_dir=ckpt,
                         **dict(short, epochs=10))
    assert sorted(os.listdir(ckpt)) == ["step_10", "step_20"]
    for key in ("loss", "res", "scale"):
        np.testing.assert_array_equal(
            np.concatenate([first.history[key], second.history[key]]),
            whole.history[key])
    np.testing.assert_array_equal(second.eigenvalues, whole.eigenvalues)
    assert second.history["scale"][0] == pytest.approx(10 / 100)


def test_profile_dir_writes_a_trace(coarsening_builds, jax_run, monkeypatch,
                                    tmp_path):
    h, _ = coarsening_builds
    prof = tmp_path / "prof"
    res = _port_train(h, jax_run, monkeypatch, profile_dir=str(prof),
                      epochs=4, scan_chunk=2, polish_iters=0)
    assert res.epochs_run == 4
    files = os.listdir(prof)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(prof / files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
