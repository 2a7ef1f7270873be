"""Parity of the port's full-window banded format with the JAX package.

The same scipy matrices and numpy U go through `eigenpinns_tpu.sparse.banded`
and `eigenpinns_torch.sparse.banded`. Tolerances:

  * layout: perm, starts and an fp32 band equal byte for byte, the
    transpose's too. A bf16 band: JAX rounds the float64 values to bf16
    in one step, the port rounds them to fp32 and then to bf16 on the
    device; the bytes are compared and any difference is held to one
    bf16 ulp (on these matrices there is none);
  * the plain version (K4 and K5's arithmetic) against both Pallas kernels
    in interpret mode (`banded_spmm_pallas`, `banded_spmm_gram_pallas`)
    at k = 5, 20, 60: W rel 1e-5, G rel 2e-5 (fp32 sums in another
    order), fp32 and bf16 alike: with a bf16 band both sides round U to
    bf16 and take the Gram from the unrounded U;
  * the plain version against `banded_spmm_reference`: rel 1e-5 in fp32;
    with a bf16 band the JAX reference multiplies by the UNROUNDED U
    while both Pallas kernels (and the port) round U (ROADMAP F10), so
    there rel 2e-2 (tests/test_sparse.py:740 gives the same bound);
  * gradients through `banded_spmm` and `banded_spmm_gram` against
    jax.grad with the same cotangents: rel 1e-5;
  * the band's nonzero table (`BandedELL.narrow`, which K4's row-wise
    route reads): its plain reader against the plain version (rel 1e-6)
    and the JAX reference (fp32, rel 1e-6) or the Pallas kernel in
    interpret mode (bf16, rel 1e-5), for the operator and its transpose.

The CUDA kernels are checked against the plain version by the
`cuda`-marked tests of tests/test_torch_cuda.py, which run only on a card.
This file also holds the port's entry points to their default device.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu.sparse import banded as jbanded
from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.geometry import point_cloud_laplacian
from eigenpinns_torch.sparse import banded as tbanded
from eigenpinns_torch.sparse.nonzeros import table_spmm_plain

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _matrix(name):
    if name == "cloud642":
        r = np.random.default_rng(7)
        X = r.normal(size=(642, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        return point_cloud_laplacian(X, n_neighbors=12)[0].tocsr()
    if name == "asym800":
        # Nonsymmetric, columns within +-90 of the row (the layout of
        # tests/test_sparse.py:161-183): needs the banded transpose.
        r = np.random.default_rng(9)
        n = 800
        rows = r.integers(0, n, 4 * n)
        cols = np.clip(rows + r.integers(-90, 90, 4 * n), 0, n - 1)
        A = sp.coo_matrix((r.normal(size=4 * n), (rows, cols)),
                          shape=(n, n)).tocsr()
        return (A + sp.diags(np.full(n, 4.0))).tocsr()
    n = 300   # the pentadiagonal operator of tests/test_sparse.py:725-727
    return sp.diags([-1.0, -0.5, 2.9, -0.5, -1.0], [-2, -1, 0, 1, 2],
                    shape=(n, n)).tocsr()


# case -> (matrix, from_scipy keyword arguments)
CASES = {
    "cloud642": ("cloud642", {}),
    "asym800": ("asym800", {"reorder": False}),
    "penta300": ("penta300", {}),
}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def ops():
    out = {}
    for case, (name, kw) in CASES.items():
        A = _matrix(name)
        for dt, (jdt, tdt) in DTYPES.items():
            jop, jperm = jbanded.BandedELL.from_scipy(A, dtype=jdt, **kw)
            top, tperm = tbanded.BandedELL.from_scipy(A, dtype=tdt,
                                                      device="cpu", **kw)
            out[case, dt] = (A, jop, jperm, top, tperm)
    return out


def _assert_layout_equal(top, jop):
    assert (top.n, top.n_cols, top.tile) == (jop.n, jop.n_cols, jop.tile)
    assert top.starts.dtype == torch.int32
    np.testing.assert_array_equal(top.starts.numpy(), np.asarray(jop.starts))
    jband = np.asarray(jop.band)
    if top.band.dtype == torch.bfloat16:
        tbits = top.band.view(torch.int16).numpy().astype(np.int32)
        jbits = jband.view(np.int16).astype(np.int32)
        differ = int((tbits != jbits).sum())
        assert np.abs(tbits - jbits).max() <= 1, differ   # <= 1 bf16 ulp
        assert differ == 0
    else:
        assert top.band.dtype == torch.float32
        np.testing.assert_array_equal(top.band.numpy(), jband)
    assert (top.transpose_banded is None) == (jop.transpose_banded is None)
    if jop.transpose_banded is not None:
        _assert_layout_equal(top.transpose_banded, jop.transpose_banded)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_banded_layout_matches_jax(ops, case, dt):
    """Same RCM order, clamped starts, band (byte for byte), transpose
    and diagonal as the JAX build."""
    _, jop, jperm, top, tperm = ops[case, dt]
    np.testing.assert_array_equal(jperm, tperm)
    _assert_layout_equal(top, jop)
    assert (top.transpose_banded is not None) == (case == "asym800")
    np.testing.assert_array_equal(top.diagonal().float().numpy(),
                                  np.asarray(jop.diagonal(), np.float32))
    assert int(top.starts.max()) <= top.band.shape[0] - top.bandwidth


def _table_pairs(top, jop):
    """[(torch op, JAX op)]: the operator and its stored transpose."""
    out = [(top, jop)]
    if top.transpose_banded is not None:
        out.append((top.transpose_banded, jop.transpose_banded))
    return out


@pytest.mark.parametrize("k", [5, 20])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["cloud642", "asym800"])
def test_banded_table_plain_reader_matches_plain_and_jax(ops, case, dt, k):
    """`from_scipy` gives the band (and its transpose) its nonzero table
    in the band's type, which K4's row-wise route reads: its plain reader
    against `banded_spmm_plain` and, in fp32, the JAX reference at rel
    1e-6 (sums in another order); in bf16, where both round U to bf16,
    against the Pallas kernel in interpret mode at rel 1e-5 (the JAX
    reference does not round U, ROADMAP F10)."""
    _, jop, _, top, _ = ops[case, dt]
    U = np.random.default_rng(k).normal(size=(top.n, k)).astype(np.float32)
    Ut, Uj = torch.from_numpy(U), jnp.asarray(U)
    for op, j_op in _table_pairs(top, jop):
        t = op.narrow
        assert t is not None and t.val.dtype == op.band.dtype
        W = table_spmm_plain(t, Ut, op.n).numpy()
        assert _rel(W, tbanded.banded_spmm_plain(op, Ut).numpy()) < 1e-6
        if dt == "f32":
            assert _rel(W, jbanded.banded_spmm_reference(j_op, Uj)) < 1e-6
        else:
            assert _rel(W, jbanded.banded_spmm_pallas(
                j_op, Uj, interpret=True)) < 1e-5


def test_banded_bandwidth_guard():
    A = _matrix("asym800")
    with pytest.raises(ValueError, match="max_bandwidth"):
        tbanded.BandedELL.from_scipy(A, reorder=False, max_bandwidth=64,
                                     device="cpu")


@pytest.mark.parametrize("k", [5, 20, 60])
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ["cloud642", "asym800"])
def test_banded_plain_matches_pallas_kernels(ops, case, dt, k):
    """The plain K4/K5 against the Pallas kernels in interpret mode, and
    against the JAX reference (F10 with a bf16 band)."""
    _, jop, _, top, _ = ops[case, dt]
    U = np.random.default_rng(k).normal(size=(top.n, k)).astype(np.float32)
    Uj, Ut = jnp.asarray(U), torch.from_numpy(U)
    W = tbanded.banded_spmm_plain(top, Ut).numpy()
    W2, G = (t.numpy() for t in tbanded.banded_spmm_gram_plain(top, Ut))
    np.testing.assert_array_equal(W, W2)
    assert _rel(W, jbanded.banded_spmm_pallas(jop, Uj, interpret=True)) < 1e-5
    Wj, Gj = jbanded.banded_spmm_gram_pallas(jop, Uj, interpret=True)
    assert _rel(W, Wj) < 1e-5
    assert _rel(G, Gj) < 2e-5
    ref = jbanded.banded_spmm_reference(jop, Uj)
    assert _rel(W, ref) < (2e-2 if dt == "bf16" else 1e-5)


@pytest.mark.parametrize("case", ["cloud642", "asym800"])
def test_banded_autograd_matches_jax(ops, case):
    """d/dU of <R, A U>, of sum sin(A U) and of the fused Gram's
    sum W^2 + sum G^2 against jax.grad: A^T from the banded transpose for
    the nonsymmetric case, A itself otherwise."""
    _, jop, _, top, _ = ops[case, "f32"]
    r = np.random.default_rng(2)
    U = r.normal(size=(top.n, 6)).astype(np.float32)
    R = r.normal(size=(top.n, 6)).astype(np.float32)
    Uj = jnp.asarray(U)

    def jgram(u):
        W, G = jbanded.banded_spmm_gram(jop, u)
        return jnp.sum(W**2) + jnp.sum(G**2)

    grads_j = [
        jax.grad(lambda u: jnp.vdot(jnp.asarray(R),
                                    jbanded.banded_spmm(jop, u)))(Uj),
        jax.grad(lambda u: jnp.sum(jnp.sin(jbanded.banded_spmm(jop, u))))(Uj),
        jax.grad(jgram)(Uj)]
    losses_t = [
        lambda u: (torch.from_numpy(R) * tbanded.banded_spmm(top, u)).sum(),
        lambda u: torch.sin(tsparse.spmm(top, u)).sum(),
        lambda u: sum((v**2).sum() for v in tsparse.spmm_gram(top, u))]
    for loss, gj in zip(losses_t, grads_j):
        Ut = torch.from_numpy(U).requires_grad_(True)
        loss(Ut).backward()
        assert _rel(Ut.grad.numpy(), gj) < 1e-5


def test_banded_bf16_gram_gradient_matches_jax_kernels(ops):
    """With a bf16 band the backward pass applies the rounded-U product,
    as the JAX VJP does through the Pallas kernels: the port's gradient
    equals dU = A^T (gW + U gG) + W gG^T built from the interpret-mode
    kernels, rel 1e-5."""
    _, jop, _, top, _ = ops["cloud642", "bf16"]
    r = np.random.default_rng(5)
    U = r.normal(size=(top.n, 5)).astype(np.float32)
    gW = r.normal(size=(top.n, 5)).astype(np.float32)
    gG = r.normal(size=(5, 5)).astype(np.float32)
    Wj, _ = jbanded.banded_spmm_gram_pallas(jop, jnp.asarray(U),
                                            interpret=True)
    rhs = jnp.asarray(gW) + jnp.asarray(U) @ jnp.asarray(gG)
    ref = (jbanded.banded_spmm_pallas(jop, rhs, interpret=True)
           + Wj @ jnp.asarray(gG).T)
    Ut = torch.from_numpy(U).requires_grad_(True)
    W, G = tbanded.banded_spmm_gram(top, Ut)
    ((W * torch.from_numpy(gW)).sum() + (G * torch.from_numpy(gG)).sum()
     ).backward()
    assert _rel(Ut.grad.numpy(), ref) < 1e-5


def test_banded_cuda_wrapper_refuses_cpu_tensors(ops):
    """The kernel wrapper never falls back: CPU tensors are refused."""
    top = ops["cloud642", "f32"][3]
    U = torch.zeros(top.n, 3)
    for with_gram in (False, True):
        with pytest.raises(ValueError, match="CUDA"):
            tbanded.banded_spmm_cuda(top, U, with_gram=with_gram)


def test_banded_hbm_bytes(ops):
    """The occupied 16 x 16 sub-blocks of the band with 16 U rows each,
    the occupancy table, starts and W; with the Gram also the tiles' own
    U rows, the per-tile partials (written, then read) and G."""
    top = ops["cloud642", "f32"][3]
    d = top.band.numpy() != 0
    occupied = int(d.reshape(d.shape[0] // 16, 16, d.shape[1] // 16, 16)
                   .any(axis=(1, 3)).sum())
    assert 0 < occupied < d.size // 256
    n_tiles = top.starts.numel()
    k = 20
    spmm = (occupied * (256 * 4 + 16 * k * 4)
            + n_tiles * (top.bandwidth // 128) * 8 + n_tiles * 4
            + top.n * k * 4)
    assert tbanded.banded_spmm_hbm_bytes(top, k) == spmm
    assert tbanded.banded_spmm_hbm_bytes(top, k, with_gram=True) == (
        spmm + top.n * k * 4 + (2 * n_tiles + 1) * k * k * 4)


def _entry_points():
    from eigenpinns_torch.sampling import Hierarchy, build_hierarchy
    from eigenpinns_torch.solvers import (
        family_operators,
        spectral_basis,
        spectral_basis_family,
    )
    from eigenpinns_torch.sparse import ops as tops

    return {
        "build_hierarchy": build_hierarchy,
        "Hierarchy.load": Hierarchy.load,
        "SparseELL.from_scipy": tsparse.SparseELL.from_scipy,
        "Diagonal.from_scipy": tsparse.Diagonal.from_scipy,
        "as_operator": tsparse.as_operator,
        "RollingBanded.from_scipy": tsparse.RollingBanded.from_scipy,
        "BSRTile.from_scipy": tsparse.BSRTile.from_scipy,
        "BandedELL.from_scipy": tsparse.BandedELL.from_scipy,
        "SplitBanded.from_scipy": tsparse.SplitBanded.from_scipy,
        "gcn_normalized_adjacency": tops.gcn_normalized_adjacency,
        "neighbor_mean_operator": tops.neighbor_mean_operator,
        "spectral_basis": spectral_basis,
        "spectral_basis_family": spectral_basis_family,
        "family_operators": family_operators,
    }


@pytest.mark.parametrize("name", list(_entry_points()))
def test_entry_points_default_to_the_card(name):
    """Every entry point that builds on a device runs on the card unless
    the caller asks for the CPU."""
    sig = inspect.signature(_entry_points()[name])
    assert sig.parameters["device"].default == "cuda"
