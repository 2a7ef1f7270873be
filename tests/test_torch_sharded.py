"""The port's node-sharded solvers against the JAX package and against
the port's single-device solvers (CPU).

One 8-rank gloo spawn (`parallel.spawn`, a FileStore under the module's
temporary directory, one torch thread a rank) runs every sharded solver
on inputs made with numpy from fixed seeds; the JAX package runs
`train_joint_sharded(n_devices=8)` on the 8-device virtual CPU mesh of
`tests/conftest.py` in this process, and the port's single-device
solvers run here too. Tolerances, stated where checked:

  * `train_joint_sharded` from the same flax parameters: loss history
    within rel 1e-4 of JAX's over the first 50 of its 100 epochs (fp32
    sums in another order, carried through Adam steps; later epochs sit
    on a loss of ~1e-4 where that noise reaches 2e-4); against the port's
    single-device `train_joint`, JAX's own bounds
    (tests/test_parallel.py): loss rel 1e-3, eigenvalues rel 1e-4,
    eigenvectors (up to sign) 1e-3, scaled residuals 0.01 apart;
  * checkpoint/resume on 8 ranks (JAX's test): `step_40` and `step_80`
    written, and the resumed run starts below the first run's start;
  * the `timing_chunks` probe reports a rate and leaves the history and
    the eigenvalues bit for bit as they were;
  * `lobpcg_sharded`, single block (40 iterations) and blocked (60 a
    sweep), from eigsh's vectors plus noise (every iteration is some 15
    dependent all-reduces, milliseconds each on 8 CPU ranks, so the runs
    are kept short): eigenvalues within 1e-3 of eigsh and 1e-5 of the
    port's single-device `lobpcg` / `lobpcg_blocked` from the same
    start, the blocked vectors M-orthonormal to 1e-3;
  * `spectral_basis(n_devices=8)` (100 iterations a sweep): eigenvalues
    within 1e-3 of eigsh;
  * `MultigridTrainer.train(n_devices=8)` against the single-device
    trainer at tests/test_multigrid.py's bounds: loss rel 1e-2,
    eigenvalues and per-level eigenvalues rel 2e-2.
"""

import os

import numpy as np
import pytest
import torch

from eigenpinns_torch import parallel as P
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.sparse import as_operator

torch.set_num_threads(2)

TRAIN = dict(n_modes=4, hidden=(32, 32), epochs=100, scan_chunk=50,
             lr_start=3e-3, lr_end=1e-3, w_res=1.0, w_orth=10.0, seed=0)
CKPT = dict(n_modes=3, hidden=(16, 16), scan_chunk=20, lr_start=2e-3,
            lr_end=1e-3, w_res=1.0, w_orth=10.0, seed=0)
MG = dict(n_modes=5, hierarchy=[64, 160], hidden_layers=[32, 32],
          epochs=120, scan_chunk=40, scale_ramp_epochs=100,
          corrector_scale=1.0, log_every=0, plateau_patience=10_000,
          polish_iters=0, loss_mxu_precision="highest",
          weight_projection=0.1, fuse_level_ops=False)
K_LOBPCG = 6
LOBPCG_ITERS = {"lobpcg": 40, "lobpcg_blocked": 60}
SB = dict(k=6, n_neighbors=14, coarse_n=400, block=3, guard=2,
          max_iter=100, tol=1e-6)


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    return X / np.linalg.norm(X, axis=1, keepdims=True)


def _rank_solvers(inp: dict) -> dict:
    """Every sharded solver on this rank (no JAX here)."""
    from eigenpinns_torch.configs import Config
    from eigenpinns_torch.sampling import Hierarchy
    from eigenpinns_torch.solvers import (
        MultigridTrainer,
        lobpcg_sharded,
        spectral_basis,
        train_joint_sharded,
    )

    mesh = P.make_mesh(device_type="cpu")
    L, M, X = inp["L"], inp["M"], inp["X"]
    out = {}
    r = train_joint_sharded(L, M, X, mesh=mesh, n_devices=8,
                            init_params=inp["init"], **TRAIN)
    out["train"] = (r.history["loss"], r.eigenvalues, r.eigenvectors)

    ck = inp["ckpt_dir"]
    r1 = train_joint_sharded(L, M, X, mesh=mesh, epochs=40,
                             checkpoint_dir=ck, **CKPT)
    r2 = train_joint_sharded(L, M, X, mesh=mesh, epochs=40,
                             checkpoint_dir=ck, **CKPT)
    out["ckpt"] = (r1.history["loss"], r1.eigenvalues, r2.history["loss"],
                   sorted(os.listdir(ck)))
    probed = train_joint_sharded(L, M, X, mesh=mesh, epochs=40,
                                 timing_chunks=1, **CKPT)
    out["probe"] = (probed.history["loss"], probed.eigenvalues,
                    probed.steady_steps_per_sec)

    out["lobpcg"] = lobpcg_sharded(
        L, M, K_LOBPCG, mesh=mesh, X=X, X0=inp["X0"],
        max_iter=LOBPCG_ITERS["lobpcg"], tol=1e-7)
    out["lobpcg_blocked"] = lobpcg_sharded(
        L, M, K_LOBPCG, mesh=mesh, X=X, X0=inp["X0"], block=3, guard=2,
        max_iter=LOBPCG_ITERS["lobpcg_blocked"], tol=1e-7)
    res = spectral_basis(inp["X_sb"], n_devices=8, log_fn=None,
                         device="cpu", **SB)
    out["spectral"] = (res.eigenvalues, res.eigenvectors)

    h = Hierarchy.load(inp["h_dir"], operator_format="auto", device="cpu")
    mg = MultigridTrainer(Config(**MG)).train(h, n_devices=8)
    out["multigrid"] = (mg.history["loss"], mg.eigenvalues,
                        mg.level_eigenvalues)
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp
    from eigenpinns_tpu.models import JointEigenNet as JJointEigenNet
    from eigenpinns_tpu.solvers import train_joint_sharded as j_sharded

    from eigenpinns_torch.configs import Config
    from eigenpinns_torch.models import JointEigenNet, from_flax_params
    from eigenpinns_torch.sampling import Hierarchy, build_hierarchy
    from eigenpinns_torch.solvers import (
        MultigridTrainer,
        eigsh_smallest,
        lobpcg,
        lobpcg_blocked,
        train_joint,
    )
    from eigenpinns_torch.utils.fixtures import perturbed_icosphere

    tmp = tmp_path_factory.mktemp("sharded")
    X = _cloud(1200, 0)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    # JAX's train_joint_sharded initializes from PRNGKey(seed) (the
    # values do not depend on the input rows); the port starts from them.
    jparams = JJointEigenNet(TRAIN["hidden"], TRAIN["n_modes"]).init(
        jax.random.PRNGKey(TRAIN["seed"]), jnp.zeros((8, 3), jnp.float32))
    init = from_flax_params(JointEigenNet(3, TRAIN["hidden"],
                                          TRAIN["n_modes"]),
                            jax.tree_util.tree_map(np.asarray, jparams))
    init = {k: v.clone() for k, v in init.state_dict().items()}
    vals, vecs = eigsh_smallest(L, M, K_LOBPCG)
    X0 = (vecs + 0.05 * np.abs(vecs).max() * np.random.default_rng(
        4).normal(size=vecs.shape)).astype(np.float32)
    X_sb = _cloud(1500, 2)
    h = build_hierarchy(perturbed_icosphere(3), MG["hierarchy"],
                        n_modes=MG["n_modes"], pc_neighbors=15,
                        operator_format="auto", device="cpu")
    h.save(str(tmp / "h"))
    inp = {"L": L, "M": M, "X": X, "init": init, "X0": X0, "X_sb": X_sb,
           "ckpt_dir": str(tmp / "ck"), "h_dir": str(tmp / "h")}
    out = P.spawn(_rank_solvers, 8, args=(inp,), store_dir=str(tmp),
                  timeout=900)

    ref = {"jax": j_sharded(L, M, X, n_devices=8, **TRAIN)}
    K_op, M_op = as_operator(L, device="cpu"), as_operator(M, device="cpu")
    ref["single"] = train_joint(K_op, M_op, X, device="cpu",
                                init_params=init, **TRAIN)
    ref["eigsh"] = vals
    ref["lobpcg"] = lobpcg(K_op, M_op, torch.as_tensor(X0),
                           max_iter=LOBPCG_ITERS["lobpcg"],
                           tol=1e-7).eigenvalues.numpy()
    ref["lobpcg_blocked"] = lobpcg_blocked(
        K_op, M_op, K_LOBPCG, block=3, guard=2,
        max_iter=LOBPCG_ITERS["lobpcg_blocked"], tol=1e-7,
        X0_full=torch.as_tensor(X0))[0]
    L_sb, M_sb = point_cloud_laplacian(X_sb, n_neighbors=SB["n_neighbors"])
    ref["eigsh_sb"] = eigsh_smallest(L_sb, M_sb, SB["k"])[0]
    h_cpu = Hierarchy.load(str(tmp / "h"), operator_format="auto",
                           device="cpu")
    ref["multigrid"] = MultigridTrainer(Config(**MG)).train(h_cpu)
    return inp, out, ref


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-9)


def test_train_joint_sharded_matches_jax(runs):
    _, out, ref = runs
    loss = out[0]["train"][0]
    assert loss.shape == (TRAIN["epochs"],)
    assert _rel(loss[:50], ref["jax"].history["loss"][:50]).max() < 1e-4


def test_train_joint_sharded_matches_single_device(runs):
    inp, out, ref = runs
    loss, lam, U8 = out[0]["train"]
    r1 = ref["single"]
    assert _rel(loss, r1.history["loss"]).max() < 1e-3
    assert (np.abs(lam - r1.eigenvalues)
            / np.maximum(np.abs(r1.eigenvalues), 1e-6)).max() < 1e-4
    U1 = r1.eigenvectors
    sign = np.sign(np.sum(U1 * U8, axis=0))
    assert np.abs(U8 * sign[None, :] - U1).max() / np.abs(U1).max() < 1e-3
    L, M = inp["L"], inp["M"]

    def scaled_resid(U, lam):
        r = np.linalg.norm(L @ U - (M @ U) * lam[None, :], axis=0)
        s = (np.linalg.norm(L @ U, axis=0)
             + np.abs(lam) * np.linalg.norm(M @ U, axis=0))
        return r / s

    assert np.abs(scaled_resid(U8, lam)
                  - scaled_resid(U1, r1.eigenvalues)).max() < 0.01
    # Every rank returns the same result.
    for rank_out in out[1:]:
        for a, b in zip(rank_out["train"], out[0]["train"]):
            np.testing.assert_array_equal(a, b)


def test_train_joint_sharded_checkpoint_resume(runs):
    _, out, _ = runs
    first, _, resumed, files = out[0]["ckpt"]
    assert "step_40" in files and "step_80" in files, files
    assert resumed[0] < first[0], (first[0], resumed[0])


def test_timing_chunks_probe_leaves_the_run_unchanged(runs):
    _, out, _ = runs
    loss, lam, rate = out[0]["probe"]
    plain_loss, plain_lam, _, _ = out[0]["ckpt"]   # the same 40 epochs
    np.testing.assert_array_equal(loss, plain_loss)
    np.testing.assert_array_equal(lam, plain_lam)
    assert rate is not None and rate > 0


@pytest.mark.parametrize("which", ["lobpcg", "lobpcg_blocked"])
def test_lobpcg_sharded_matches_eigsh_and_single_device(runs, which):
    inp, out, ref = runs
    vals, vecs, _ = out[0][which]
    assert _rel(vals[1:], ref["eigsh"][1:]).max() < 1e-3
    assert _rel(vals[1:], ref[which][1:]).max() < 1e-5
    M = inp["M"]
    R = inp["L"] @ vecs - (M @ vecs) * vals[None, :]
    assert np.linalg.norm(R) / np.linalg.norm(vecs) < 1e-2
    if which == "lobpcg_blocked":
        G = vecs.T @ (M @ vecs)
        assert np.abs(G - np.eye(K_LOBPCG)).max() < 1e-3


def test_spectral_basis_sharded_matches_eigsh(runs):
    _, out, ref = runs
    vals, _ = out[0]["spectral"]
    assert _rel(vals[1:], ref["eigsh_sb"][1:]).max() < 1e-3


def test_multigrid_sharded_matches_single_device(runs):
    _, out, ref = runs
    loss, lam, levels = out[0]["multigrid"]
    r1 = ref["multigrid"]
    assert _rel(loss, r1.history["loss"]).max() < 1e-2
    assert (np.abs(lam - r1.eigenvalues)
            / np.maximum(np.abs(r1.eigenvalues), 1e-6)).max() < 2e-2
    for a, b in zip(levels, r1.level_eigenvalues):
        assert (np.abs(a - b) / np.maximum(np.abs(b), 1e-6)).max() < 2e-2


def test_sharded_fuse_request_warns(tmp_path):
    """An explicit fuse_level_ops=True on the sharded path warns (one
    rank: the warning is the JAX trainer's)."""
    out = P.spawn(_rank_fuse_warning, 1, store_dir=str(tmp_path),
                  timeout=300)
    assert out[0], "no warning"


def _rank_fuse_warning() -> bool:
    import warnings

    from eigenpinns_torch.configs import Config
    from eigenpinns_torch.geometry.mesh import TriMesh
    from eigenpinns_torch.sampling import build_hierarchy
    from eigenpinns_torch.solvers import MultigridTrainer

    g = 8
    xs, ys = np.meshgrid(np.linspace(0, 1, g), np.linspace(0, 1, g))
    verts = np.stack([xs.ravel(), ys.ravel(), 0.05 * np.sin(6 * xs.ravel())],
                     axis=1)
    quads = (np.arange(g * g).reshape(g, g))[:-1, :-1].ravel()
    faces = np.concatenate([
        np.stack([quads, quads + 1, quads + g], axis=1),
        np.stack([quads + 1, quads + g + 1, quads + g], axis=1)])
    h = build_hierarchy(TriMesh(verts, faces), [32, g * g], n_modes=3,
                        pc_neighbors=10, device="cpu")
    cfg = Config(n_modes=3, hierarchy=[32, g * g], hidden_layers=[8],
                 epochs=2, scan_chunk=2, log_every=0, polish_iters=0,
                 fuse_level_ops=True)
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        MultigridTrainer(cfg).train(h, mesh=P.make_mesh(device_type="cpu"))
    return any("fuse_level_ops" in str(w.message) for w in seen)
