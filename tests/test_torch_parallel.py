"""The port's multi-device layer against the JAX package's (CPU).

The JAX side runs on the 8-device virtual CPU mesh that
`tests/conftest.py` sets up, in this process; the port runs its plain
kernel versions on gloo CPU ranks started by `parallel.spawn` (a
FileStore under `tmp_path`, one torch thread a rank). Each spawn costs
seconds, so one 8-rank spawn carries every collective check. Inputs are
made with numpy from fixed seeds; every tolerance is stated where it is
checked:

  * the host tables of `build_sharded_operator` (band, starts, band_t,
    starts_t, perm, kind, the remainder's indices and values) equal
    JAX's byte for byte for 1, 4 and 8 shards on a 1200-point cloud and
    on the FEM of perturbed_icosphere(3), and the halo validation
    refuses what JAX's refuses, with the same message;
  * `banded_spmm_plain` on a rectangular block read against a U longer
    than N_pad + B (a halo window) equals JAX's `banded_spmm_reference`
    to 1e-6 (it cropped that U before);
  * each shard block and transpose that `ShardedBanded.block` gives
    carries its nonzero table, whose plain reader equals
    `banded_spmm_plain` to 1e-6 and JAX's `banded_spmm_reference` on the
    JAX host tables to rel 1e-5, for 1 and 4 shards;
  * on 8 ranks, forward pass and VJP of `all_gather_spmm`, `halo_spmm`,
    `psum_gram`, `sharded_banded_spmm` and `sharded_split_spmm`, and the
    ring and the Gram on a 4 x 2 mesh, equal JAX's to rel 1e-5;
  * one `make_dp_train_step` step on 1 rank and on 8 equals JAX's to
    1e-5;
  * `graft_entry_torch.dryrun_multichip(8)` passes (~15 s alone).

Worker functions import nothing of JAX: the spawned ranks import this
module.
"""

import contextlib
import os

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_torch import parallel as P
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.geometry.fem import assemble_stiffness_mass
from eigenpinns_torch.sparse import BandedELL, banded_spmm_plain
from eigenpinns_torch.utils.fixtures import perturbed_icosphere

torch.set_num_threads(2)

REL = 1e-5          # sharded vs JAX, forward and VJP
K_COLS = 4


def _cloud(n, seed):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    return X / np.linalg.norm(X, axis=1, keepdims=True)


def _banded_operator(n, width):
    diags = [np.full(n - abs(o), -1.0 / (1 + abs(o)))
             for o in range(-width, width + 1)]
    return sp.diags(diags, list(range(-width, width + 1))).tocsr()


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def operators():
    X = _cloud(1200, 0)
    L, _ = point_cloud_laplacian(X, n_neighbors=15)
    ico = perturbed_icosphere(3)
    K3, _ = assemble_stiffness_mass(ico)
    return {"cloud": (L.tocsr(), X), "ico3": (K3.tocsr(), ico.verts)}


@pytest.fixture(scope="module")
def mesh8():
    from eigenpinns_tpu.parallel import make_mesh

    return make_mesh(8)


# ---- host tables ---------------------------------------------------------

@pytest.mark.parametrize("name", ["cloud", "ico3"])
@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_host_tables_match_jax(operators, name, n_dev):
    from eigenpinns_tpu.parallel import sharded_banded as jsb

    A, X = operators[name]
    jkind, (jcore, jrem), jperm = jsb.build_sharded_operator(A, n_dev, X=X)
    kind, (core, rem), perm = P.build_sharded_operator(A, n_dev, X=X,
                                                       device="cpu")
    assert kind == jkind
    np.testing.assert_array_equal(perm, jperm)
    assert (core.n, core.n_dev, core.per, core.B, core.tile) == (
        jcore.n, jcore.n_dev, jcore.per, jcore.B, jcore.tile)
    for field in ("band", "starts", "band_t", "starts_t"):
        np.testing.assert_array_equal(getattr(core, field).numpy(),
                                      np.asarray(getattr(jcore, field)),
                                      field)
    np.testing.assert_array_equal(
        core.diagonal().numpy()[:core.n], np.asarray(jcore.diagonal()))
    assert (rem is None) == (jrem is None)
    if rem is not None:
        np.testing.assert_array_equal(rem.indices, np.asarray(jrem.indices))
        np.testing.assert_array_equal(rem.values, np.asarray(jrem.values))


@pytest.mark.parametrize("case", ["max_bandwidth", "per", "halo"])
def test_halo_validation_refuses_like_jax(operators, case):
    from eigenpinns_tpu.parallel import sharded_banded as jsb

    A, _ = operators["cloud"]
    if case == "max_bandwidth":
        kw = dict(n_dev=1, max_bandwidth=256)
    elif case == "per":
        kw = dict(n_dev=8)
    else:   # narrow tiles whose entries lie two shards to the left
        rows = np.arange(300, 1024)
        A = sp.csr_matrix((np.ones(rows.size), (rows, rows - 300)),
                          shape=(1024, 1024))
        kw = dict(n_dev=4, reorder=False)
    with pytest.raises(ValueError) as jerr:
        jsb.ShardedBanded.from_scipy(A, **kw)
    with pytest.raises(ValueError) as err:
        P.ShardedBanded.from_scipy(A, device="cpu", **kw)
    assert str(err.value) == str(jerr.value)


def test_banded_spmm_plain_reads_a_longer_u():
    """A (128 x 384) block whose tile starts at row 256 of a 384-row U
    (the right halo), and a real shard block and its transpose: the
    plain version reads U as it is, as JAX's pad_u does."""
    import jax.numpy as jnp

    from eigenpinns_tpu.parallel import sharded_banded as jsb
    from eigenpinns_tpu.sparse.banded import BandedELL as JBandedELL
    from eigenpinns_tpu.sparse.banded import banded_spmm_reference

    rng = np.random.default_rng(3)
    band = rng.normal(size=(128, 128)).astype(np.float32)
    starts = np.array([256], np.int32)
    U = rng.normal(size=(384, 5)).astype(np.float32)
    blocks = [(band, starts, 128, 384, U)]
    A = _banded_operator(2048, 3)
    jop, _ = jsb.ShardedBanded.from_scipy(A, 4, reorder=False)
    s = 2
    Uw = rng.normal(size=(jop.win, 5)).astype(np.float32)
    g = rng.normal(size=(jop.per, 5)).astype(np.float32)
    blocks.append((np.asarray(jop.band[s]), np.asarray(jop.starts[s]),
                   jop.per, jop.win, Uw))
    blocks.append((np.asarray(jop.band_t[s]), np.asarray(jop.starts_t[s]),
                   jop.win, jop.per, g))
    for band, starts, n, n_cols, U in blocks:
        ref = banded_spmm_reference(
            JBandedELL(jnp.asarray(band), jnp.asarray(starts), n, n_cols,
                       128), jnp.asarray(U))
        A_t = BandedELL(torch.as_tensor(band), torch.as_tensor(starts), n,
                        n_cols, 128)
        out = banded_spmm_plain(A_t, torch.as_tensor(U))
        assert out.shape == (n, U.shape[1])
        assert _rel(out.numpy(), ref) < 1e-6


@pytest.mark.parametrize("name", ["cloud", "ico3"])
@pytest.mark.parametrize("n_dev", [1, 4])
def test_shard_blocks_carry_their_tables(operators, name, n_dev):
    """`ShardedBanded.block` gives each shard's block and its transpose
    the nonzero table of its band (`full_band_table`), which K4's
    row-wise route reads. Read by its plain reader (`table_spmm_plain`),
    each table gives `banded_spmm_plain`'s product on its block to rel
    1e-6, and JAX's `banded_spmm_reference` on the JAX package's host
    tables of the same block (a U of the halo window's rows for the
    block, of the shard's rows for the transpose) to REL."""
    import jax.numpy as jnp

    from eigenpinns_torch.sparse.nonzeros import band_table, table_spmm_plain
    from eigenpinns_tpu.parallel import sharded_banded as jsb
    from eigenpinns_tpu.sparse.banded import BandedELL as JBandedELL
    from eigenpinns_tpu.sparse.banded import banded_spmm_reference

    A, X = operators[name]
    _, (jcore, _), _ = jsb.build_sharded_operator(A, n_dev, X=X)
    _, (core, _), _ = P.build_sharded_operator(A, n_dev, X=X, device="cpu")
    rng = np.random.default_rng(n_dev)
    for s in range(n_dev):
        blk = core.block(s, "cpu")
        jblocks = (JBandedELL(jcore.band[s], jcore.starts[s], jcore.per,
                              jcore.win, jcore.tile),
                   JBandedELL(jcore.band_t[s], jcore.starts_t[s], jcore.win,
                              jcore.per, jcore.tile))
        for op, jop in zip((blk, blk.transpose_banded), jblocks):
            fresh = band_table(op.band, op.occupancy, op.starts)
            for a, b in ((op.narrow.val, fresh.val),
                         (op.narrow.idx, fresh.idx),
                         (op.narrow.slice_start, fresh.slice_start)):
                assert torch.equal(a, b)
            assert op.narrow.nnz == int(torch.count_nonzero(op.band))
            U = rng.normal(size=(op.n_cols, K_COLS)).astype(np.float32)
            W = table_spmm_plain(op.narrow, torch.from_numpy(U), op.n)
            assert W.shape == (op.n, K_COLS)
            assert _rel(W.numpy(), banded_spmm_plain(
                op, torch.from_numpy(U)).numpy()) < 1e-6
            assert _rel(W.numpy(), banded_spmm_reference(
                jop, jnp.asarray(U))) < REL


# ---- the collectives on 8 gloo ranks ---------------------------------------

def _fwd_vjp(f, u_local, g_local):
    """(f(u), the VJP of f at u with cotangent g), this rank's rows."""
    u = u_local.clone().requires_grad_(True)
    y = f(u)
    y.backward(g_local)
    return y.detach(), u.grad


def _rank_collectives(cases: dict) -> dict:
    """Every case on this rank; returns the gathered outputs."""
    mesh = P.make_mesh(device_type="cpu")
    out = {}
    for name, c in cases.items():
        if name == "dp":
            continue
        if name == "gram":
            u = P.shard_array(c["U"], mesh, "data").requires_grad_(True)
            v = P.shard_array(c["V"], mesh, "data").requires_grad_(True)
            G = P.psum_gram(mesh)(u, v)
            # One copy of the cotangent in all: the psum's backward pass
            # sums the ranks' cotangents.
            gG = torch.as_tensor(c["gG"]) * (mesh.axis_index() == 0)
            (G * gG).sum().backward()
            out[name] = (G.detach().numpy(), P.gather_rows(u.grad, mesh),
                         P.gather_rows(v.grad, mesh))
            continue
        if name == "mesh2":
            m2 = P.make_mesh(8, axis_names=("data", "model"), shape=(4, 2),
                             device_type="cpu")
            op = P.ShardedOperator.from_ell(_ell(c["A"]), 4)
            u = P.shard_array(c["U"], m2, "data")
            y = P.gather_rows(P.halo_spmm(op, m2, axis="data")(u), m2)
            G = P.psum_gram(m2, axis="data")(u, u)
            core, _ = P.ShardedBanded.from_scipy(
                c["K"], 4, device="cpu", shards=(m2.axis_index("data"),))
            yb, gb = _fwd_vjp(P.sharded_banded_spmm(core, m2, "data"),
                              P.shard_array(c["Ub"], m2, "data"),
                              P.shard_array(c["gb"], m2, "data"))
            out[name] = (y, G.numpy(), P.gather_rows(yb, m2),
                         P.gather_rows(gb, m2))
            continue
        if name in ("all_gather", "halo"):
            op = P.ShardedOperator.from_ell(_ell(c["A"]), 8)
            f = (P.all_gather_spmm if name == "all_gather"
                 else P.halo_spmm)(op, mesh)
        else:
            kind, (core, rem), perm = P.build_sharded_operator(
                c["A"], 8, X=c.get("X"), device="cpu",
                shards=(mesh.axis_index(),), **c["kw"])
            assert kind == c["kind"], kind
            f = (P.sharded_banded_spmm(core, mesh) if rem is None
                 else P.sharded_split_spmm(core, rem, mesh))
        y, g = _fwd_vjp(f, P.shard_array(c["U"], mesh, "data"),
                        P.shard_array(c["g"], mesh, "data"))
        out[name] = (P.gather_rows(y, mesh), P.gather_rows(g, mesh))
    out["dp"] = _dp_step(mesh, cases["dp"])
    return out


def _ell(A):
    from eigenpinns_torch.sparse import SparseELL

    return SparseELL.from_scipy(A, device="cpu")


def _dp_step(mesh, c):
    """One DP step of the JAX test's problem: mean(U^2) + mean(batch),
    both means over the global batch through the psum."""
    from eigenpinns_torch.models import JointEigenNet, from_flax_params

    model = from_flax_params(JointEigenNet(3, (16,), 3), c["params"])
    n, k = c["X"].shape[0], 3
    opt = torch.optim.SGD(model.parameters(), lr=1e-2)

    def loss_fn(batch):
        U = model(batch)
        return (P.psum((U**2).sum(), mesh) / (n * k)
                + P.psum(batch.sum(), mesh) / (n * 3))

    step = P.make_dp_train_step(loss_fn, opt, mesh)
    loss = float(step(P.shard_array(c["X"], mesh, "data")))
    return loss, [p.detach().numpy().copy() for p in model.parameters()]


@contextlib.contextmanager
def _one_rank_group(tmp_path):
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store1",
                            rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _jax_fwd_vjp(f, U, g, mesh8):
    import jax
    import jax.numpy as jnp
    from eigenpinns_tpu.parallel import shard_array
    from jax.sharding import PartitionSpec as JP

    Us = shard_array(jnp.asarray(U), mesh8, JP("data"))
    y, vjp = jax.vjp(f, Us)
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


@pytest.fixture(scope="module")
def collectives(mesh8, operators, tmp_path_factory):
    """The cases, JAX's answers on the 8-device mesh, and the port's
    from one 8-rank spawn."""
    import jax
    import jax.numpy as jnp
    import optax
    from eigenpinns_tpu import parallel as jpar
    from eigenpinns_tpu.models import JointEigenNet as JJointEigenNet
    from eigenpinns_tpu.sparse import SparseELL as JSparseELL
    from jax.sharding import PartitionSpec as JP

    rng = np.random.default_rng(11)
    cases, ref = {}, {}

    def padded(n_pad, n, k=K_COLS):
        U = np.zeros((n_pad, k), np.float32)
        U[:n] = rng.normal(size=(n, k))
        return U

    A = sp.random(203, 203, density=0.05,
                  random_state=np.random.RandomState(1)).tocsr()
    A = (A + A.T).tocsr()
    for name, A in (("all_gather", A), ("halo", _banded_operator(240, 3))):
        jop = jpar.ShardedOperator.from_ell(JSparseELL.from_scipy(A), 8)
        n_pad = jop.n_dev * jop.rows_per_dev
        U, g = padded(n_pad, A.shape[0]), padded(n_pad, A.shape[0])
        f = (jpar.all_gather_spmm if name == "all_gather"
             else jpar.halo_spmm)(jop, mesh8)
        cases[name] = {"A": A, "U": U, "g": g}
        ref[name] = _jax_fwd_vjp(f, U, g, mesh8)

    ico4 = perturbed_icosphere(4)
    K4, _ = assemble_stiffness_mass(ico4)
    X2 = _cloud(2000, 5)
    L2, _ = point_cloud_laplacian(X2, n_neighbors=14)
    for name, A, X, kw, kind in (
            ("sharded_banded", K4.tocsr(), None, {}, "banded"),
            ("sharded_split", L2.tocsr(), X2,
             dict(max_bandwidth=128, window=128), "split")):
        jkind, (jcore, jrem), _ = jpar.build_sharded_operator(
            A, 8, X=X, **kw)
        assert jkind == kind
        U, g = padded(jcore.n_pad, A.shape[0]), padded(jcore.n_pad,
                                                        A.shape[0])
        f = (jpar.sharded_banded_spmm(jcore, mesh8) if jrem is None
             else jpar.sharded_split_spmm(jcore, jrem, mesh8))
        cases[name] = {"A": A, "X": X, "kw": kw, "kind": kind, "U": U,
                       "g": g}
        ref[name] = _jax_fwd_vjp(f, U, g, mesh8)

    U, V = (rng.normal(size=(160, 5)).astype(np.float32) for _ in range(2))
    gG = rng.normal(size=(5, 5)).astype(np.float32)
    G, vjp = jax.vjp(jpar.psum_gram(mesh8),
                     jpar.shard_array(jnp.asarray(U), mesh8, JP("data")),
                     jpar.shard_array(jnp.asarray(V), mesh8, JP("data")))
    cases["gram"] = {"U": U, "V": V, "gG": gG}
    ref["gram"] = (np.asarray(G),
                   *(np.asarray(x) for x in vjp(jnp.asarray(gG))))

    # The 4 x 2 mesh: the ring and the Gram on the data axis, and the
    # halo-banded SpMM of the icosphere FEM (4 shards: banded).
    mesh2 = jpar.make_mesh(8, axis_names=("data", "model"), shape=(4, 2))
    A2 = _banded_operator(512, 3)
    jop = jpar.ShardedOperator.from_ell(JSparseELL.from_scipy(A2), 4)
    U2 = rng.normal(size=(512, 5)).astype(np.float32)
    K3 = operators["ico3"][0]
    jcore, perm3 = jpar.ShardedBanded.from_scipy(K3, 4)
    Ub, gb = padded(jcore.n_pad, K3.shape[0]), padded(jcore.n_pad,
                                                       K3.shape[0])
    y2 = np.asarray(jpar.halo_spmm(jop, mesh2, axis="data")(
        jpar.shard_array(jnp.asarray(U2), mesh2, JP("data"))))
    G2 = np.asarray(jpar.psum_gram(mesh2, axis="data")(U2, U2))
    yb, gbv = _jax_fwd_vjp(jpar.sharded_banded_spmm(jcore, mesh2, "data"),
                           Ub, gb, mesh2)
    cases["mesh2"] = {"A": A2, "U": U2, "K": K3, "Ub": Ub, "gb": gb}
    ref["mesh2"] = (y2, G2, yb, gbv)

    # One DP step: the JAX test's problem and optimizer.
    X = rng.normal(size=(64, 3)).astype(np.float32)
    jmodel = JJointEigenNet((16,), n_modes=3)
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(X))
    opt = optax.sgd(1e-2)

    def loss_fn(params, batch):
        U = jmodel.apply(params, batch)
        return jnp.mean(U**2) + jnp.mean(batch)

    step = jpar.make_dp_train_step(loss_fn, opt, mesh8)
    p8, _, l8 = step(params, opt.init(params), jnp.asarray(X))
    cases["dp"] = {"X": X, "params": jax.tree_util.tree_map(np.asarray,
                                                            params)}
    from eigenpinns_torch.models import JointEigenNet, from_flax_params

    tmodel = from_flax_params(JointEigenNet(3, (16,), 3),
                              jax.tree_util.tree_map(np.asarray, p8))
    ref["dp"] = (float(l8), [p.detach().numpy().copy()
                             for p in tmodel.parameters()])

    store = str(tmp_path_factory.mktemp("store"))
    out = P.spawn(_rank_collectives, 8, device="cpu", args=(cases,),
                  store_dir=store, timeout=600)
    with _one_rank_group(store):
        one = _dp_step(P.make_mesh(device_type="cpu"), cases["dp"])
    return cases, ref, out, one


@pytest.mark.parametrize("name", ["all_gather", "halo", "sharded_banded",
                                  "sharded_split"])
def test_sharded_spmm_forward_and_vjp_match_jax(collectives, name):
    cases, ref, out, _ = collectives
    n = cases[name]["A"].shape[0]
    for port, jax_ in zip(out[0][name], ref[name]):
        assert _rel(np.asarray(port)[:n], jax_[:n]) < REL


def test_every_rank_returns_the_same(collectives):
    _, _, out, _ = collectives
    for rank_out in out[1:]:
        for name in ("halo", "sharded_split"):
            for a, b in zip(rank_out[name], out[0][name]):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_psum_gram_forward_and_vjp_match_jax(collectives):
    _, ref, out, _ = collectives
    for port, jax_ in zip(out[0]["gram"], ref["gram"]):
        assert _rel(np.asarray(port), jax_) < REL


def test_two_axis_mesh_matches_jax(collectives):
    """The ring, the Gram and the halo-banded SpMM address only the data
    axis of a 4 x 2 mesh."""
    cases, ref, out, _ = collectives
    n3 = cases["mesh2"]["K"].shape[0]
    y, G, yb, gb = out[0]["mesh2"]
    jy, jG, jyb, jgb = ref["mesh2"]
    assert _rel(np.asarray(y)[:512], jy[:512]) < REL
    assert _rel(G, jG) < REL
    assert _rel(np.asarray(yb)[:n3], jyb[:n3]) < REL
    assert _rel(np.asarray(gb)[:n3], jgb[:n3]) < REL


def test_dp_train_step_one_rank_eight_ranks_and_jax(collectives):
    """One DP step on 1 rank and on 8 equals JAX's 8-device step (loss
    and parameters to 1e-5)."""
    _, ref, out, one = collectives
    jl, jp = ref["dp"]
    for loss, params in (out[0]["dp"], one):
        assert abs(loss - jl) < 1e-5
        for a, b in zip(params, jp):
            assert np.abs(a - b).max() < 1e-5


def test_spawn_reports_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        P.spawn(_fail_on_rank_one, 2, device="cpu", store_dir=str(tmp_path),
                timeout=120)


def test_spawn_defaults_to_the_card(monkeypatch, tmp_path):
    """The default device is the card; without one spawn raises and
    starts no rank."""
    import inspect

    assert inspect.signature(P.spawn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for device in ("cuda", "cuda:0"):
        with pytest.raises(RuntimeError, match="is_available"):
            P.spawn(_fail_on_rank_one, 2, device=device,
                    store_dir=str(tmp_path))
    assert not list(tmp_path.iterdir())


def _fail_on_rank_one():
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank one fails")
    return 0


def test_make_mesh_needs_a_group():
    with pytest.raises(RuntimeError, match="initialized"):
        P.make_mesh(device_type="cpu")


def test_dryrun_multichip_eight_ranks(capsys):
    import graft_entry_torch

    out = graft_entry_torch.dryrun_multichip(8)
    assert np.isfinite(out["dp_loss"]) and np.isfinite(
        out["multigrid_loss"])
    text = capsys.readouterr().out
    assert "dryrun_multichip(8): OK" in text
    assert os.path.exists(graft_entry_torch.__file__)
