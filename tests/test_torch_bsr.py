"""Parity of the port's strip-BSR format with the JAX package.

The same scipy matrices and numpy U go through `eigenpinns_tpu.sparse.bsr`
and `eigenpinns_torch.sparse.bsr`. Tolerances:

  * layout: every array equal, byte for byte;
  * the plain version against both Pallas kernels in interpret mode
    (`bsr_spmm_pallas`, `bsr_spmm_pallas_grouped`): rel 1e-5 in every
    mode. In 'bf16' both sides round U to bf16, so only the summation
    order differs; in 'high' the Pallas kernels take the bf16x3 split
    product (~5e-6 rel) where the port is exact fp32;
  * the plain version against `bsr_spmm_reference`: rel 1e-5 in fp32. In
    'bf16' the JAX reference multiplies bf16 strips by the UNROUNDED U
    while both Pallas kernels (and the port) round U to bf16 (ROADMAP
    F8), so the two differ by U's rounding: rel 2e-3 (the cases here
    reach 1.3e-3 to 1.8e-3; tests/test_sparse.py gives the same
    comparison 3e-3);
  * gradients and the Gram epilogue: rel 1e-5.

The CUDA kernels are checked against the plain version by the
`cuda`-marked tests of tests/test_torch_cuda.py, which run only on a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from eigenpinns_tpu.geometry import point_cloud_laplacian as j_pcl
from eigenpinns_tpu.sparse import bsr as jbsr
from eigenpinns_torch import sparse as tsparse
from eigenpinns_torch.sparse import bsr as tbsr

# The suite runs in several worker processes on a few cores; one torch
# thread per core in each makes their thread pools contend.
torch.set_num_threads(2)

PRECISIONS = ("highest", "high", "bf16")


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


def _banded900():
    """The banded n=900 operator of tests/test_sparse.py:763-773."""
    r = np.random.default_rng(11)
    n = 900
    rows, cols, vals = [], [], []
    for i in range(n):
        for d in r.integers(-150, 150, 5):
            rows.append(i)
            cols.append(min(max(i + int(d), 0), n - 1))
            vals.append(r.normal())
    A = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    return (A + A.T).tocsr()


def _matrix(name):
    if name == "sym700":
        n = 700
        A = sp.random(n, n, density=0.01, random_state=1, format="csr")
        return (A + A.T + sp.diags(np.ones(n) * 2.0)).tocsr()
    if name == "asym800":
        r = np.random.default_rng(9)
        n = 800
        rows = r.integers(0, n, 4 * n)
        cols = np.clip(rows + r.integers(-90, 90, 4 * n), 0, n - 1)
        return sp.coo_matrix((r.normal(size=4 * n), (rows, cols)),
                             shape=(n, n)).tocsr()
    if name == "cloud642":
        r = np.random.default_rng(7)
        X = r.normal(size=(642, 3))
        X /= np.linalg.norm(X, axis=1, keepdims=True)
        return j_pcl(X, n_neighbors=12)[0].tocsr()
    return _banded900()


# case -> (matrix, from_scipy keyword arguments)
CASES = {
    "sym700": ("sym700", {}),
    "asym800": ("asym800", {}),
    "banded900_G8": ("banded900", {"group": 8}),
    "banded900_G2": ("banded900", {"group": 2}),
    "group0": ("banded900", {"group": 0}),
    "pad_chunks": ("banded900", {"with_transpose": False,
                                 "pad_chunks_to": "+5"}),
    "cloud642": ("cloud642", {}),
}


def _build(case):
    name, kw = CASES[case]
    A = _matrix(name)
    kw = dict(kw)
    if kw.get("pad_chunks_to") == "+5":
        base, _ = jbsr.BSRTile.from_scipy(A, with_transpose=False)
        kw["pad_chunks_to"] = base.n_chunks + 5
    jop, jperm = jbsr.BSRTile.from_scipy(A, **kw)
    top, tperm = tbsr.BSRTile.from_scipy(A, device="cpu", **kw)
    return A, jop, jperm, top, tperm


@pytest.fixture(scope="module")
def ops():
    return {case: _build(case) for case in CASES}


def _jax_nv(jop):
    """The valid-slot counts and chunk offsets bsr_spmm_pallas_grouped
    derives (eigenpinns_tpu/sparse/bsr.py:456-462)."""
    rowid, nw = np.asarray(jop.rowid), np.asarray(jop.nw)
    first = np.concatenate(([0], np.cumsum(np.bincount(
        rowid, minlength=nw.shape[0]))))
    slot0 = (np.arange(rowid.shape[0]) - first[rowid]) * jop.chunk
    return np.clip(nw[rowid] - slot0, 0, jop.chunk), first


def _assert_layout_equal(top, jop):
    assert (top.n, top.n_cols, top.tile, top.static_layout) == (
        jop.n, jop.n_cols, jop.tile, jop.static_layout)
    np.testing.assert_array_equal(top.data.numpy(), np.asarray(jop.data))
    np.testing.assert_array_equal(top.diag.numpy(), np.asarray(jop.diag))
    for name in ("cid", "rowid", "nw", "gcid", "lcid", "gid"):
        t, j = getattr(top, name), getattr(jop, name)
        assert (t is None) == (j is None), name
        if j is not None:
            assert t.dtype == torch.int32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), name)
    nv, first = _jax_nv(jop)
    np.testing.assert_array_equal(top.nv.numpy(), nv)
    np.testing.assert_array_equal(top.first_chunk_of_row.numpy(), first)
    assert (top.transpose_bsr is None) == (jop.transpose_bsr is None)
    if jop.transpose_bsr is not None:
        _assert_layout_equal(top.transpose_bsr, jop.transpose_bsr)


@pytest.mark.parametrize("case", list(CASES))
def test_bsr_layout_matches_jax(ops, case):
    """Same RCM order, strips, tables (group tables with the adaptive
    halving of G), diagonal and explicit transpose as the JAX build."""
    _, jop, jperm, top, tperm = ops[case]
    np.testing.assert_array_equal(jperm, tperm)
    _assert_layout_equal(top, jop)
    if case in ("group0",):
        assert top.gcid is None
    if case == "asym800":
        assert top.transpose_bsr is not None
        assert top.transpose_bsr.gcid is not None
    if case == "pad_chunks":
        assert int(top.nv[-5:].sum()) == 0


def test_bsr_static_layout_false_builds_no_group_tables():
    A = _matrix("sym700")
    top, _ = tbsr.BSRTile.from_scipy(A, static_layout=False,
                                    device="cpu")
    jop, _ = jbsr.BSRTile.from_scipy(A, static_layout=False)
    assert top.gcid is None and jop.gcid is None
    _assert_layout_equal(top, jop)


@pytest.mark.parametrize("case", ["sym700", "asym800", "banded900_G2",
                                  "group0", "pad_chunks", "cloud642"])
def test_bsr_plain_matches_pallas_kernels_and_reference(ops, case):
    _, jop, _, top, _ = ops[case]
    U = np.random.default_rng(1).normal(size=(top.n, 5)).astype(np.float32)
    Uj, Ut = jnp.asarray(U), torch.from_numpy(U)
    for prec in PRECISIONS:
        jo, to = jop.with_precision(prec), top.with_precision(prec)
        W = tbsr.bsr_spmm_plain(to, Ut).numpy()
        pallas = [jbsr.bsr_spmm_pallas(jo, Uj, interpret=True)]
        if jo.gcid is not None:
            pallas.append(jbsr.bsr_spmm_pallas_grouped(jo, Uj,
                                                       interpret=True))
        for Wp in pallas:
            assert _rel(W, Wp) < 1e-5, prec
        ref = jbsr.bsr_spmm_reference(jo, Uj)
        assert _rel(W, ref) < (2e-3 if prec == "bf16" else 1e-5), prec


@pytest.mark.parametrize("case", ["sym700", "asym800"])
def test_bsr_autograd_matches_jax(ops, case):
    """d/dU <G, A U> and d/dU sum sin(A U) against jax.grad: A^T from the
    stored transpose for the asymmetric case, A itself otherwise."""
    _, jop, _, top, _ = ops[case]
    r = np.random.default_rng(2)
    U = r.normal(size=(top.n, 5)).astype(np.float32)
    G = r.normal(size=(top.n, 5)).astype(np.float32)
    Uj = jnp.asarray(U)
    g1 = jax.grad(lambda u: jnp.vdot(jnp.asarray(G),
                                     jbsr.bsr_spmm(jop, u)))(Uj)
    g2 = jax.grad(lambda u: jnp.sum(jnp.sin(jbsr.bsr_spmm(jop, u))))(Uj)
    Ut = torch.from_numpy(U).requires_grad_(True)
    (torch.from_numpy(G) * tbsr.bsr_spmm(top, Ut)).sum().backward()
    assert _rel(Ut.grad.numpy(), g1) < 1e-5
    Ut.grad = None
    torch.sin(tsparse.spmm(top, Ut)).sum().backward()
    assert _rel(Ut.grad.numpy(), g2) < 1e-5


def test_bsr_spmm_gram_matches_jax(ops):
    _, jop, _, top, _ = ops["cloud642"]
    U = np.random.default_rng(3).normal(size=(top.n, 6)).astype(np.float32)

    def jf(u):
        W, G = jbsr.bsr_spmm_gram(jop, u)
        return jnp.sum(W**2) + jnp.sum(G**2)

    Wj, Gj = jbsr.bsr_spmm_gram(jop, jnp.asarray(U))
    gj = jax.grad(jf)(jnp.asarray(U))
    Ut = torch.from_numpy(U).requires_grad_(True)
    W, G = tsparse.spmm_gram(top, Ut)
    ((W**2).sum() + (G**2).sum()).backward()
    assert _rel(W.detach().numpy(), Wj) < 1e-5
    assert _rel(G.detach().numpy(), Gj) < 1e-5
    assert _rel(Ut.grad.numpy(), gj) < 1e-5


def test_bsr_with_precision_roundtrip(ops):
    """'bf16' stores bf16 strips; back to 'highest' upcasts them to fp32
    (the values keep their bf16 rounding), sharing the layout tables."""
    _, _, _, top, _ = ops["cloud642"]
    b = top.with_precision("bf16")
    assert b.data.dtype == torch.bfloat16 and b.mxu_precision == "bf16"
    h = b.with_precision("highest")
    assert h.data.dtype == torch.float32 and h.cid is top.cid
    np.testing.assert_array_equal(h.data.numpy(),
                                  b.data.float().numpy())
    assert top.with_precision("high").data is top.data
    with pytest.raises(ValueError):
        top.with_precision("fp8")


def test_bsr_cuda_wrappers_refuse_cpu_tensors(ops):
    """The kernel wrappers never fall back: CPU tensors are refused."""
    _, _, _, top, _ = ops["sym700"]
    U = torch.zeros(top.n, 3)
    for launch in (tbsr.bsr_spmm_grouped_cuda, tbsr.bsr_spmm_burst_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            launch(top, U)


def _occupied_sub_blocks(dense: torch.Tensor) -> int:
    """16 x 16 sub-blocks of a dense layout that hold a nonzero."""
    d = dense.float().numpy() != 0
    r, c = d.shape
    return int(d.reshape(r // 16, 16, c // 16, 16).any(axis=(1, 3)).sum())


def test_bsr_hbm_bytes_follow_the_dispatched_kernel(ops):
    """Both kernels read the occupied 16 x 16 sub-blocks (with 16 U rows
    each), every slot's occupancy word and column entry, the row tiles'
    chunk ranges, and write W; the grouped kernel reads its group tables
    on top (the walk: fp32 strips past ROWS_MAX_K, bf16 strips). On fp32
    strips up to ROWS_MAX_K both take a route over the narrow table (the
    narrow path at k = 1, the row-wise route at k = 20): every entry of
    the narrow table (value and U row, padding included), its slice
    starts, each nonzero's U row, and W."""
    _, _, _, top, _ = ops["banded900_G8"]
    _, _, _, top0, _ = ops["group0"]
    k = tsparse.bsr.ROWS_MAX_K + 1
    for op in (top, top0):
        occupied = _occupied_sub_blocks(op.data)
        assert 0 < occupied < 64 * op.n_slots
        want = (occupied * (256 * 4 + 16 * k * 4)
                + op.n_chunks * op.chunk * 12 + (op.n_row_tiles + 1) * 4
                + op.n * k * 4)
        if op.gcid is not None:
            want += (op.gcid.numel() + op.gid.numel()) * 4
        assert tsparse.bsr_spmm_hbm_bytes(op, k) == want
    assert top.gcid is not None and top0.gcid is None
    bf16 = top.with_precision("bf16")
    assert (tsparse.bsr_spmm_hbm_bytes(top, k)
            - tsparse.bsr_spmm_hbm_bytes(bf16, k)
            == _occupied_sub_blocks(top.data) * 256 * 2)
    for op in (top, top0):
        t = op.narrow
        nnz = int(torch.count_nonzero(op.data))
        for width in (1, 20):
            assert tsparse.bsr_spmm_hbm_bytes(op, width) == (
                t.val.numel() * 8 + (t.n_slices + 1) * 8 + nnz * width * 4
                + op.n * width * 4)
    assert tsparse.bsr_spmm_hbm_bytes(bf16, 1) == (
        tsparse.bsr_spmm_hbm_bytes(bf16, k)
        - _occupied_sub_blocks(top.data) * 16 * (k - 1) * 4
        - top.n * (k - 1) * 4)
