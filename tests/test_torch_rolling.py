"""The rolling band's occupancy table and the walk its CUDA kernel makes.

The kernel (the rolling instantiation of `csrc/banded_spmm.cu`) runs only
on a card, so its index arithmetic is held here on the CPU by a pure-torch
emulation of the walk: for every set bit of `RollingBanded.occupancy`, the
16 x 16 sub-block of the rotated band times the 16 rows of U that the
kernel's `piece` formula names (piece p of tile t multiplies U rows
128 t + ((128 p - 128 t) mod B') - pre onward; rows outside [0, n) are
zero). Inputs come from numpy seeds and go through both packages.

  * the table equals a numpy count from the scipy matrix's triplets,
    bit for bit (symmetric and nonsymmetric operators, pre > 0, n not a
    multiple of 128, the stored transpose, after `with_precision`);
  * the emulated walk equals `rolling_spmm_plain` and the JAX package's
    `rolling_spmm_pallas(interpret=True)` / `rolling_spmm_reference` to
    rel 1e-5 (fp32 sums in another order); in 'bf16' to rel 1e-5 against
    the interpret-mode kernel, which rounds U as the port does, and to
    4e-3 against the JAX reference, which does not (rounding U to bf16
    moves each term by up to 2^-9 of itself; measured 2.2e-3); no
    occupied sub-block starts before U's row 0;
  * the wrapper raises without a table and for a tile other than 128;
  * `train_joint` on a rolling K with a 'bf16' loss operator follows the
    JAX trainer's loss history with copied parameters (rel 1e-3, the
    tolerance tests/test_torch_direct.py uses for 'bf16': the JAX fused
    Gram on the CPU takes the plain-reference path).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu import sparse as jsparse
from eigenpinns_tpu.models import JointEigenNet as JJointEigenNet
from eigenpinns_tpu.solvers.direct import train_joint as j_train_joint
from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.models import JointEigenNet, from_flax_params
from eigenpinns_torch.solvers import train_joint
from eigenpinns_torch.utils.fixtures import (
    adversarial_rolling_matrix,
    make_cloud,
)

torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _asym800():
    r = np.random.default_rng(9)
    n = 800
    rows = r.integers(0, n, 4 * n)
    cols = np.clip(rows + r.integers(-90, 90, 4 * n), 0, n - 1)
    A = sp.coo_matrix((r.normal(size=4 * n), (rows, cols)),
                      shape=(n, n)).tocsr()
    return (A + sp.diags(np.full(n, 4.0))).tocsr()


def _case(name):
    """(matrix, reorder): a 900-point cloud Laplacian (symmetric, RCM),
    a nonsymmetric band of 800 rows, and the adversarial operator."""
    if name == "cloud":
        X = np.random.default_rng(20240818).normal(size=(900, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        return point_cloud_laplacian(X, n_neighbors=12)[0].tocsr(), True
    if name == "nonsymmetric":
        return _asym800(), False
    return adversarial_rolling_matrix(), False


CASES = ["cloud", "nonsymmetric", "adversarial"]


@pytest.fixture(scope="module")
def ops():
    out = {}
    for name in CASES:
        A, reorder = _case(name)
        top, perm = tsparse.RollingBanded.from_scipy(A, reorder=reorder,
                                                     device="cpu")
        jop, jperm = jsparse.RollingBanded.from_scipy(A, reorder=reorder)
        np.testing.assert_array_equal(perm, jperm)
        out[name] = (A[perm][:, perm].tocsr(), top, jop)
    return out


def _expected_table(op, Ap):
    """The occupancy of `op`'s rotated band from the triplets of the
    matrix it stores."""
    n_pad, bp = op.band.shape
    coo = Ap.tocoo()
    rows, cols = coo.row, (coo.col + op.pre) % bp
    bits = np.uint64(1) << (8 * ((rows % 128) // 16)
                            + (cols % 128) // 16).astype(np.uint64)
    want = np.zeros((n_pad // 128, bp // 128), np.uint64)
    np.bitwise_or.at(want, (rows // 128, cols // 128), bits)
    return want


def _as_u64(mask):
    return mask.numpy().view(np.uint64)


@pytest.mark.parametrize("name", CASES)
def test_rolling_occupancy_matches_triplets(ops, name):
    Ap, op, _ = ops[name]
    assert op.pre > 0 and op.n % 128 and op.tile == 128
    assert op.occupancy.dtype == torch.int64
    assert op.occupancy.shape == (op.band.shape[0] // 128,
                                  op.band.shape[1] // 128)
    np.testing.assert_array_equal(_as_u64(op.occupancy),
                                  _expected_table(op, Ap))
    t = op.transpose_rolling
    assert (t is None) == (name == "cloud")
    if t is not None:
        np.testing.assert_array_equal(_as_u64(t.occupancy),
                                      _expected_table(t, Ap.T.tocsr()))
    # fp32 -> bf16 -> fp32 keeps the source's table, the transpose's too;
    # a bf16 build takes the same table from the bf16 band.
    b = op.with_precision("bf16")
    h = b.with_precision("highest")
    assert b.occupancy is op.occupancy and h.occupancy is op.occupancy
    if t is not None:
        assert b.transpose_rolling.occupancy is t.occupancy
    A, reorder = _case(name)
    direct, _ = tsparse.RollingBanded.from_scipy(
        A, dtype=torch.bfloat16, reorder=reorder, device="cpu")
    assert torch.equal(direct.occupancy, op.occupancy)


def test_adversarial_operator_is_adversarial(ops):
    """Tile 1 is a single sub-block on the sign bit, tile 0's window
    starts before row 0 and the last tile's ends past n."""
    _, op, _ = ops["adversarial"]
    assert (op.pre, op.win, tuple(op.band.shape)) == (256, 640, (1024, 768))
    words = op.occupancy[1].tolist()
    assert sorted(words) == [-2**63] + [0] * 5
    assert 0 * 128 - op.pre < 0
    assert 7 * 128 - op.pre + op.win > op.n
    assert op.transpose_rolling is not None


def walk_product(op, U):
    """W = A U as the CUDA kernel computes it: tile by tile and piece by
    piece over the set bits of the occupancy table, each 16 x 16
    sub-block times the 16 U rows the kernel's `piece` formula names.
    'bf16' rounds U to bf16 first. Also returns the smallest first U row
    of an occupied sub-block."""
    band = op.band.float()
    n_pad, bp = band.shape
    table = _as_u64(op.occupancy)
    Uf = U.float()
    if op.mxu_precision == "bf16":
        Uf = Uf.bfloat16().float()
    W = torch.zeros((n_pad, U.shape[1]))
    lowest = op.n
    for t in range(n_pad // 128):
        row0 = t * 128
        shift = row0 % bp
        for p in range(bp // 128):
            word = int(table[t, p])
            c = p * 128
            ub = row0 - op.pre + (c - shift if c >= shift else c - shift + bp)
            for bit in range(64):
                if not (word >> bit) & 1:
                    continue
                i, j = bit // 8, bit % 8
                urow0 = ub + 16 * j
                lowest = min(lowest, urow0)
                rows = torch.arange(urow0, urow0 + 16)
                live = (rows >= 0) & (rows < op.n)
                Ublk = torch.zeros((16, U.shape[1]))
                Ublk[live] = Uf[rows[live]]
                r = row0 + 16 * i
                W[r:r + 16] += band[r:r + 16, c + 16 * j:c + 16 * j + 16] @ Ublk
    return W[: op.n], lowest


@pytest.mark.parametrize("precision", ["highest", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_walk_matches_plain_and_jax(ops, name, precision):
    Ap, top, jop = ops[name]
    top, jop = top.with_precision(precision), jop.with_precision(precision)
    U = np.random.default_rng(1).normal(size=(top.n, 7)).astype(np.float32)
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    for t_op, j_op, A_sp in ((top, jop, Ap),
                             (top.transpose_rolling, jop.transpose_rolling,
                              Ap.T)):
        if t_op is None:
            continue
        W, lowest = walk_product(t_op, Ut)
        assert lowest >= 0   # an occupied sub-block holds a real column
        W_plain = tsparse.rolling_spmm_plain(t_op, Ut).numpy()
        W_pl = np.asarray(jsparse.rolling_spmm_pallas(j_op, Uj,
                                                      interpret=True))
        W_ref = np.asarray(jsparse.rolling.rolling_spmm_reference(j_op, Uj))
        assert _rel(W.numpy(), W_plain) < 1e-5
        assert _rel(W.numpy(), W_pl) < 1e-5
        assert _rel(W.numpy(), W_ref) < (4e-3 if precision == "bf16"
                                         else 1e-5)
        if precision == "highest":
            assert _rel(W.numpy(), A_sp @ U.astype(np.float64)) < 1e-5


def test_rolling_cuda_wrapper_needs_table_and_tile_128(ops):
    """No dense fallback: without the table, or with a tile the walk does
    not take, the wrapper raises (before it looks at the device)."""
    _, op, _ = ops["cloud"]
    U = torch.zeros(op.n, 3)
    for with_gram in (False, True):
        with pytest.raises(ValueError, match="occupancy"):
            tsparse.rolling_spmm_cuda(
                dataclasses.replace(op, occupancy=None), U,
                with_gram=with_gram)
    A, _ = _case("cloud")
    op64, _ = tsparse.RollingBanded.from_scipy(A, tile=64, device="cpu")
    assert op64.occupancy is None
    with pytest.raises(ValueError, match="tile = 128"):
        tsparse.rolling_spmm_cuda(op64, U)
    with pytest.raises(ValueError, match="CUDA"):   # never the plain version
        tsparse.rolling_spmm_cuda(op, U)
    # the plain version takes any tile
    Ur = torch.from_numpy(np.random.default_rng(2).normal(
        size=(op.n, 4)).astype(np.float32))
    assert _rel(tsparse.rolling_spmm_plain(op64, Ur).numpy(),
                tsparse.rolling_spmm_plain(op, Ur).numpy()) < 1e-5


TRAIN = dict(n_modes=6, hidden=(32, 32), epochs=30, scan_chunk=15,
             mode="penalty", w_res=1.0, w_orth=10.0, w_trace=0.05,
             lr_start=1e-2, lr_end=1e-3, seed=0, rayleigh_ritz_finish=False,
             loss_mxu_precision="bf16")


def test_train_joint_on_rolling_band_matches_jax():
    """The 300k bench phase's configuration at small size: a rolling K,
    the fused Gram in the loss, a bf16 loss operator."""
    X = make_cloud(2300, seed=1)
    L, M = point_cloud_laplacian(X, n_neighbors=15)
    jK, perm = jsparse.RollingBanded.from_scipy(L, max_bandwidth=8192)
    tK, tperm = tsparse.RollingBanded.from_scipy(L, max_bandwidth=8192,
                                                 device="cpu")
    np.testing.assert_array_equal(perm, tperm)
    m = np.asarray(M.diagonal())[perm]
    jM = jsparse.Diagonal(jnp.asarray(m, jnp.float32))
    tM = tsparse.Diagonal(torch.as_tensor(m, dtype=torch.float32))
    Xp = X[perm]
    jres = j_train_joint(jK, jM, Xp, **TRAIN)
    jparams = JJointEigenNet(TRAIN["hidden"], TRAIN["n_modes"]).init(
        jax.random.PRNGKey(TRAIN["seed"]), jnp.asarray(Xp, jnp.float32))
    net = from_flax_params(
        JointEigenNet(3, TRAIN["hidden"], TRAIN["n_modes"]),
        jax.tree_util.tree_map(np.asarray, jparams))
    res = train_joint(tK, tM, Xp, init_params=net.state_dict(), **TRAIN)
    assert res.epochs_run == jres.epochs_run == 30
    assert _rel(res.history["loss"], jres.history["loss"]) < 1e-3
    assert _rel(res.eigenvalues, jres.eigenvalues) < 1e-3
    assert res.eigenvectors.shape == (2300, 6)
    assert np.isfinite(res.eigenvectors).all()
